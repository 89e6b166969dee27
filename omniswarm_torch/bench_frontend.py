"""Secondary benchmark: the visual front-end's throughput on one card.

Counterpart of the root ``bench_frontend.py``: SuperPoint (forward, NMS
by K2, top-K, descriptor sampling, PCA) and MobileNetVLAD global
descriptors, f32 under ``highp`` (true-f32 cuDNN convolutions, the
production front-end's setting), on one omnidirectional keyframe's 4
views at 400 x 208 (``nodelet-sfisheye.launch:45-46``), 50 calls after a
warm-up, synchronised at the end. The extractors are the reference
bench's (``omniswarm_torch.bench.random_weights``).

    python -m omniswarm_torch.bench_frontend [--device cuda|cpu]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from omniswarm_torch.bench import extractors, random_weights
from omniswarm_torch.benchutil import sync
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp

H, W, B = 208, 400, 4    # 4 fisheye directions per keyframe
CALLS = 50


@highp()
def run(device="cuda", hw=(H, W), batch: int = B,
        calls: int = CALLS) -> dict:
    dev = resolve_device(device)
    h, w = hw
    sp, nv = extractors(random_weights(), torch.float32, dev)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(size=(batch, h, w)).astype(
        np.float32))[:, None].to(dev)
    sync((sp(imgs), nv(imgs)))
    t0 = time.perf_counter()
    for _ in range(calls):
        out = (sp(imgs), nv(imgs))
    sync(out)
    dt = (time.perf_counter() - t0) / calls
    views_per_s = batch / dt
    return {"metric": "frontend_views_per_s_400x208_sp_plus_netvlad",
            "value": round(views_per_s, 2), "unit": "views/s",
            "keyframes_per_s_4dir": round(views_per_s / 4, 2),
            "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m omniswarm_torch.bench_frontend",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    out = run(ap.parse_args(argv).device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
