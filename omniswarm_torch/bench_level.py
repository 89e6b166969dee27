"""Time the K1 and K2 kernels against another checkout's, in turns.

    python -m omniswarm_torch.bench_level DIR [--kernels fused_level grid_nms]

Needs a CUDA card. DIR is the root of another checkout, e.g. an unpacked
``git archive`` of the parent commit. Builds both trees' kernels and times
the other tree's fused-level (K1) and grid-NMS (K2) kernels and this tree's
on the same inputs in turns: other, this, this, other, twice (CUDA-event
medians, ``benchutil.time_ms``).

- K1 at each level shape the solves launch (``benchutil.SOLVE_LEVELS``:
  m = 40 with t = 32, 16, 8, 4 at 5 x 100; m = 80 with t = 128 ... 4 at
  5 x 1024 and t = 256 ... 4 at 10 x 1024), warm-branch inputs; then K1's
  per-iteration sums for each drones x frames.
- K2 at (40, 208, 400), one front-end step, and (3, 40, 70), r = 4, on u**8
  heat: warm (one input, in L2) and cold (``benchutil.time_cold_ms`` over
  10 distinct inputs, read from HBM at the main shape).

Prints the card and one JSON line per shape. It checks no result:
``chip_smoke.py`` holds the kernels against their plain versions.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from omniswarm_torch import kernels
from omniswarm_torch.benchutil import (SOLVE_LEVELS, bound, card,
                                       level_bound_ms, random_level,
                                       time_cold_ms, time_ms)
from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver.fused_level import _pad_b

ROUNDS = 2
NMS_SHAPES = ((40, 208, 400), (3, 40, 70))
NMS_RADIUS = 4


def other_kernels(root: Path):
    """The ``kernels`` module of another checkout, under its own name (it
    builds that checkout's csrc/ into that checkout's build/)."""
    spec = importlib.util.spec_from_file_location(
        "other_kernels", root / "omniswarm_torch" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_call(mod, A, B, X0):
    """The other tree's kernel on the same level. Trees whose kernel reads
    B[2t-1] take B padded with a zero block, and their wrapper refuses the
    unpadded B; then it gets the padded copy, made here once."""
    try:
        mod.fused_level(A, B, X0, 0.95)
    except ValueError:
        B = _pad_b(A, B)
    return lambda: mod.fused_level(A, B, X0, 0.95)


def in_turns(theirs, mine):
    """(this tree's times, the other's): other, this, this, other, ROUNDS
    times."""
    ms, oms = [], []
    for _ in range(ROUNDS):
        oms.append(theirs())
        ms += [mine(), mine()]
        oms.append(theirs())
    return ms, oms


def bench_fused_level(other) -> None:
    rng = np.random.default_rng(0)
    per_iter = {}
    with highp():
        for F, D, m, ts in SOLVE_LEVELS:
            total = dict(ms=0.0, other_ms=0.0, bound_ms=0.0)
            for t in ts:
                A, B, X0 = (torch.from_numpy(v).cuda()
                            for v in random_level(rng, 2 * t, m, "warm"))
                mine = lambda: kernels.fused_level(A, B, X0, 0.95)  # noqa: E731
                theirs = other_call(other, A, B, X0)
                ms, oms = in_turns(lambda: time_ms(theirs),
                                   lambda: time_ms(mine))
                b_ms, by = level_bound_ms(m, t)
                row = dict(kernel="fused_level", F=F, D=D, m=m, t=t,
                           cluster=kernels.fused_level_cluster(m, t),
                           ms=statistics.median(ms), ms_runs=ms,
                           other_ms=statistics.median(oms),
                           other_ms_runs=oms, bound_ms=b_ms, bound_by=by)
                for key in total:
                    total[key] += row[key]
                print(json.dumps(row), flush=True)
            per_iter[f"{D}x{F}"] = total
    print(json.dumps({"k1_ms_per_iteration": per_iter}), flush=True)


def bench_grid_nms(other) -> None:
    rng = np.random.default_rng(1)
    r = NMS_RADIUS
    for shape in NMS_SHAPES:
        heats = [torch.from_numpy((rng.uniform(size=shape) ** 8).astype(
            np.float32)).cuda() for _ in range(10)]
        row = dict(kernel="grid_nms", shape=list(shape), r=r)
        timers = {
            "ms": lambda mod: time_ms(lambda: mod.grid_nms(heats[0], r)),
            "cold_ms": lambda mod: time_cold_ms(
                lambda h: mod.grid_nms(h, r), heats)}
        for key, timer in timers.items():
            ms, oms = in_turns(lambda: timer(other), lambda: timer(kernels))
            row.update({key: statistics.median(ms), f"{key}_runs": ms,
                        f"other_{key}": statistics.median(oms),
                        f"other_{key}_runs": oms})
        n = heats[0].numel()
        row["bound_ms"], row["bound_by"] = bound(8 * n, n * (4 * r + 1))
        print(json.dumps(row), flush=True)
        del heats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--kernels", nargs="+", default=["fused_level",
                                                     "grid_nms"],
                    choices=["fused_level", "grid_nms"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_level: needs a CUDA card")
    print(card("cuda"), flush=True)
    kernels.build(args.kernels)
    other = other_kernels(args.other)
    other.build(args.kernels)
    if "fused_level" in args.kernels:
        bench_fused_level(other)
    if "grid_nms" in args.kernels:
        bench_grid_nms(other)
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
