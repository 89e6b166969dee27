#!/usr/bin/env python3
"""Is the PyTorch port's seed-0 solve reproducible on the card?

    python3 tools/torch_repro_solve.py [--root DIR] [--frames 100 1024]
                                       [--modes default deterministic]

Needs a CUDA card. For each window size F and each of two modes, one child
process imports ``omniswarm_torch`` from DIR (default: this checkout; e.g. an
unpacked ``git archive`` of another commit), runs ``entry(num_frames=F)``
(5 drones, seed 0, 20 LM iterations, fused levels) twice and prints one JSON
line: both final costs (``float.hex``), whether they and the poses are
bit-equal, and the largest pose difference. The modes:

- ``default``: the port as it runs;
- ``deterministic``: ``torch.use_deterministic_algorithms(True)`` with
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts. An op without
  a deterministic implementation raises there; its message is reported.

This is a diagnostic: the package itself never sets the flag.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

MODES = ("default", "deterministic")


def child(root: Path, F: int, mode: str) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if mode == "deterministic":
        torch.use_deterministic_algorithms(True)
    from omniswarm_torch.entry import entry

    out = dict(F=F, mode=mode)
    try:
        runs = [entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                      max_iterations=20) for _ in range(2)]
    except RuntimeError as exc:                   # a nondeterministic op
        out["error"] = str(exc).splitlines()[0]
        return out
    a, b = runs
    out.update(costs=[a.cost, b.cost],
               costs_hex=[a.cost.hex(), b.cost.hex()],
               cost_equal=a.cost == b.cost,
               poses_equal=bool(np.array_equal(a.poses, b.poses)),
               max_pose_diff=float(np.abs(a.poses - b.poses).max()),
               rel_cost_diff=abs(a.cost - b.cost) / abs(a.cost),
               relative_ate=[a.relative_ate, b.relative_ate])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--frames", type=int, nargs="+", default=[100, 1024])
    ap.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    ap.add_argument("--child", nargs=2, metavar=("F", "MODE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.root.resolve(), int(args.child[0]),
                               args.child[1])), flush=True)
        return
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for F in args.frames:
        for mode in args.modes:
            env = dict(os.environ)
            if mode == "deterministic":
                env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            subprocess.run([sys.executable, __file__, "--root",
                            str(args.root.resolve()), "--child", str(F),
                            mode], env=env, check=True, timeout=900)


if __name__ == "__main__":
    main()
