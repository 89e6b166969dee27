"""SuperPoint matched-keypoint precision on textured and flat imagery.

    python -m omniswarm_torch.tools.eval_superpoint_textured
        --ckpt magicpoint=weights/superpoint_synthetic.npz
        --ckpt photometric=weights/superpoint_photometric.npz
        [--n-eval 24] [--out PATH] [--device cuda|cpu]

Counterpart of ``tools/eval_superpoint_textured.py``: for each checkpoint
(``name=path``, repeatable; a path that does not exist is looked up under
``omniswarm_tpu/models/``, where the bundled ``weights/*.npz`` lie), the
matched-keypoint precision and match count under a 0.5 rad viewpoint
change, zoom 0.85-1.2 and photometric jitter, on textured surfaces and on
flat line art (``train_entry.textured_eval`` over
``models/train_superpoint.matching_metrics``, ``--n-eval`` pairs each;
K2 runs in the detector), in true f32 (``highp``: no TF32 convolutions).
Prints one JSON object (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from omniswarm_torch.benchutil import card, refuse_reference_output
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.models.superpoint import WEIGHTS_DIR
from omniswarm_torch.train_entry import textured_eval

REFERENCE_OUTPUTS = ("SP_EVAL_*.json",)


def evaluate(specs, n_eval: int = 24, device="cuda") -> dict:
    """The tool's JSON object for ``name=path`` specs."""
    dev = resolve_device(device)
    ckpts = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        if not os.path.exists(path):
            path = str(WEIGHTS_DIR.parent / path)
        ckpts[name] = path
    with torch.no_grad(), highp():
        results = textured_eval(ckpts, n_eval=n_eval, device=dev)
    return {"description": f"SuperPoint matched-keypoint precision under "
                           f"0.5 rad viewpoint + zoom + photometric jitter, "
                           f"on textured-surface vs flat line-art imagery "
                           f"({card(dev)})",
            "checkpoints": {name: {k: r[k] for k in (
                "textured_match_precision", "textured_matches",
                "flat_match_precision", "flat_matches")}
                for name, r in results.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.eval_superpoint_textured",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", action="append", required=True,
                    help="name=path.npz (repeatable)")
    ap.add_argument("--n-eval", type=int, default=24)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.out is not None:
        refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    out = evaluate(args.ckpt, args.n_eval, args.device)
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
