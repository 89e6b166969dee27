#!/usr/bin/env python3
"""Are the PyTorch port's seed-0 solves reproducible on the card?

    python3 tools/torch_repro_solve.py [--root DIR] [--frames 100 1024]
                                       [--modes default deterministic]
                                       [--paths smw pcg exact dense generic]

Needs a CUDA card. For each window size F, each solver path and each of two
modes, one child process imports ``omniswarm_torch`` from DIR (default: this
checkout; e.g. an unpacked ``git archive`` of another commit), runs the
solve (5 drones, seed 0, 20 LM iterations, function_tolerance 0) twice and
prints one JSON line: both final costs (``float.hex``), whether they and
the poses are bit-equal, and the largest pose difference. The paths:

- ``smw``, ``pcg``, ``exact``: ``entry(num_frames=F)`` with the default
  Woodbury path (fused levels), ``linear="pcg"`` or ``exact_linear=True``;
- ``dense``, ``generic``: the gold paths ``lm_solve_dense`` and
  ``lm_solve`` (on ``build_graph_from_sim(enable_detections=True)``), run
  only at F <= 100 (their Hessian is dense in all 4FD parameters).

The modes:

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
PATHS = ("smw", "pcg", "exact", "dense", "generic")
GOLD_MAX_F = 100


def _solve(F: int, path: str):
    """(cost, poses) of one seed-0 solve on the card."""
    from omniswarm_torch import sim
    from omniswarm_torch.entry import entry
    from omniswarm_torch.sim.pipeline import build_graph_from_sim
    from omniswarm_torch.solver.dense import (dense_graph_from_sim,
                                              lm_solve_dense)
    from omniswarm_torch.solver.gauss_newton import lm_solve

    kw = dict(device="cuda", max_iterations=20)
    if path in ("smw", "pcg", "exact"):
        res = entry(num_frames=F, num_drones=5, seed=0,
                    linear="pcg" if path == "pcg" else "auto",
                    exact_linear=path == "exact", **kw)
        return res.cost, res.poses
    data = sim.generate(sim.SimParams(num_drones=5, num_frames=F, seed=0))
    if path == "dense":
        res = lm_solve_dense(dense_graph_from_sim(data), data.vio,
                             function_tolerance=0.0, **kw)
    else:
        graph, init = build_graph_from_sim(data, enable_detections=True)
        res = lm_solve(graph, init, function_tolerance=0.0, **kw)
    return float(res.cost), res.poses.cpu().numpy()


def child(root: Path, F: int, mode: str, path: str) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if mode == "deterministic":
        torch.use_deterministic_algorithms(True)

    out = dict(F=F, path=path, mode=mode)
    try:
        (ca, pa), (cb, pb) = (_solve(F, path) for _ in range(2))
    except RuntimeError as exc:                   # a nondeterministic op
        out["error"] = str(exc).splitlines()[0]
        return out
    out.update(costs=[ca, cb], costs_hex=[ca.hex(), cb.hex()],
               cost_equal=ca == cb,
               poses_equal=bool(np.array_equal(pa, pb)),
               max_pose_diff=float(np.abs(pa - pb).max()),
               rel_cost_diff=abs(ca - cb) / abs(ca))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--frames", type=int, nargs="+", default=[100, 1024])
    ap.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    ap.add_argument("--child", nargs=3, metavar=("F", "MODE", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.root.resolve(), int(args.child[0]),
                               args.child[1], args.child[2])), flush=True)
        return
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for F in args.frames:
        for path in args.paths:
            if path in ("dense", "generic") and F > GOLD_MAX_F:
                continue
            for mode in args.modes:
                env = dict(os.environ)
                if mode == "deterministic":
                    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
                subprocess.run([sys.executable, __file__, "--root",
                                str(args.root.resolve()), "--child", str(F),
                                mode, path], env=env, check=True,
                               timeout=900)


if __name__ == "__main__":
    main()
