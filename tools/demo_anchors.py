#!/usr/bin/env python3
"""Reference anchors for the demos phase (9a) of ``chip_smoke.py``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/demo_anchors.py [--feature-only]
    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/demo_anchors.py --drones 10

Drives the two sessions of ``omniswarm_torch/demo_entry.py``
(``run_feature_demo``, ``run_image_demo``: the frame loop of the examples)
with a ``Kit`` of the JAX package (the reference) on the CPU: its nodes,
bus, parameters, simulator, ``VisualWorld``, ``OmniLoopCam``, metrics,
loop keys and relative poses. The image demo's views are rendered by the
reference's ``RoomWorld`` and ``examples/run_image_demo.py``'s
``render_direction_stereo`` in the demo's order. The feature demo is 3
drones x 30 frames over the ``VisualWorld``; the image demo 5 drones x 30
frames, 75 keyframes of 4-direction stereo at 400 x 208.

With ``--drones D`` (D other than 5) it runs only the image demo, at D
drones x 30 frames (phase 13a's 10-drone tier: 150 keyframes, 80 views a
step), under the key ``image_d<D>``; at D=10 it took 4548.8 s and 12.11 GB
peak RSS on an 8-core CPU that other jobs shared.

Prints one JSON object to paste into ``chip_smoke.py``'s ``DEMO_ANCHORS``:
per demo the unique loop keys, the false ones, recall, precision before and
after PCM, and per drone the cost and the relative ATE (and raw VIO's). Its
wall time and peak resident memory go to stderr.
"""
from __future__ import annotations

import importlib.util
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KEEP = ("loop_keys", "false_keys", "loop_recall", "loop_precision",
        "loop_precision_post_pcm", "loops_unique", "loops_found",
        "loops_received", "revisit_opportunities", "all_solved")


def anchors_of(res: dict) -> dict:
    out = {k: res[k] for k in KEEP}
    out["per_drone"] = [
        {k: d[k] for k in ("drone", "cost", "relative_ate_cm",
                           "vio_relative_ate_cm")} for d in res["per_drone"]]
    return out


def reference_kit():
    from omniswarm_torch.demo_entry import Kit
    from omniswarm_tpu import sim
    from omniswarm_tpu.config import FrontendParams, SolverParams
    from omniswarm_tpu.eval import metrics
    from omniswarm_tpu.sim.simulator import delta_pose_np, wrap
    from omniswarm_tpu.sim.visual_world import VisualWorld
    from omniswarm_tpu.swarm.comm import LossyBus
    from omniswarm_tpu.swarm.estimator import loop_key
    from omniswarm_tpu.swarm.loop_cam import OmniLoopCam
    from omniswarm_tpu.swarm.node import DroneNode

    return Kit(DroneNode, LossyBus, FrontendParams, SolverParams, VisualWorld,
               OmniLoopCam, sim, metrics, loop_key, delta_pose_np, wrap, {})


def reference_prep(D: int):
    """The image demo's views for ``D`` drones rendered by the reference,
    in the demo's order (run_image_demo.py:78-140), as
    ``frontend_entry.Prepared``."""
    from omniswarm_torch import demo_entry as de
    from omniswarm_torch.frontend_entry import Prepared
    from omniswarm_tpu import sim
    from omniswarm_tpu.config import FrontendParams
    from omniswarm_tpu.sim.image_world import RoomWorld
    from omniswarm_tpu.swarm.loop_cam import CameraIntrinsics, OmniLoopCam

    spec = importlib.util.spec_from_file_location(
        "run_image_demo", ROOT / "examples" / "run_image_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    F, kf_every = de.FRAMES, de.KF_EVERY
    data = sim.generate(sim.SimParams(
        num_drones=D, num_frames=F, seed=7, radius_range=(2.0, 3.5),
        z_range=(0.8, 2.0)))
    fp = FrontendParams(height=208, width=400, match_index_dist=4,
                        netvlad_thres=0.35)
    intr = CameraIntrinsics(fx=220, fy=220, cx=fp.width / 2,
                            cy=fp.height / 2)
    world = RoomWorld(half=6.0, seed=11)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    steps = []
    for k in range(0, F, kf_every):
        t = float(data.times[k])
        steps.append([(d, k, t, data.vio[k, d], [
            demo.render_direction_stereo(world, data.gt[k, d], vy, intr,
                                         fp.height, fp.width, rng)
            for vy in OmniLoopCam.VIEW_YAWS]) for d in range(D)])
    return Prepared(data, fp, intr, steps, time.perf_counter() - t0,
                    kf_every)


def main() -> int:
    import argparse

    from omniswarm_torch.demo_entry import (IMAGE_DRONES, run_feature_demo,
                                            run_image_demo)

    ap = argparse.ArgumentParser()
    ap.add_argument("--feature-only", action="store_true")
    ap.add_argument("--drones", type=int, default=IMAGE_DRONES,
                    help="image demo drones; other than 5: the image demo "
                         "alone, as image_d<D>")
    args = ap.parse_args()
    kit = reference_kit()
    t0 = time.perf_counter()
    out = {}
    if args.drones == IMAGE_DRONES:
        out["feature"] = anchors_of(run_feature_demo(kit))
        print(f"feature demo {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if not args.feature_only:
        t1 = time.perf_counter()
        key = ("image" if args.drones == IMAGE_DRONES
               else f"image_d{args.drones}")
        out[key] = anchors_of(run_image_demo(kit, reference_prep(
            args.drones)))
        print(f"image demo {time.perf_counter() - t1:.1f} s",
              file=sys.stderr, flush=True)
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"demo anchors: {time.perf_counter() - t0:.1f} s wall, peak RSS "
          f"{rss_gb:.2f} GB", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
