"""Time the fused-level kernel (K1) against another checkout's, in turns.

    python -m omniswarm_torch.bench_level DIR

Needs a CUDA card. DIR is the root of another checkout, e.g. an unpacked
``git archive`` of the parent commit. Builds both trees' kernels and, at each
level shape the solve launches (m = 40 with t = 32, 16, 8, 4 at F=100; m = 80
with t = 128 ... 4 at F=1024), times the other tree's kernel and this one's
on the same warm-branch inputs in turns: other, this, this, other, twice
(CUDA-event medians, ``benchutil.time_ms``). Prints the card, one JSON line
per shape and K1's per-iteration sums at each F. It checks no result:
``chip_smoke.py`` holds the kernel against its plain version.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from omniswarm_torch import kernels
from omniswarm_torch.benchutil import (SOLVE_LEVELS, level_bound_ms,
                                       random_level, time_ms)
from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver.fused_level import _pad_b

ROUNDS = 2


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_level: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    kernels.build(["fused_level"])
    other = other_kernels(args.other)
    rng = np.random.default_rng(0)
    per_iter = {}
    with highp():
        for F, m, ts in SOLVE_LEVELS:
            total = dict(ms=0.0, other_ms=0.0, bound_ms=0.0)
            for t in ts:
                A, B, X0 = (torch.from_numpy(v).cuda()
                            for v in random_level(rng, 2 * t, m, "warm"))
                mine = lambda: kernels.fused_level(A, B, X0, 0.95)  # noqa: E731
                theirs = other_call(other, A, B, X0)
                ms, oms = [], []
                for _ in range(ROUNDS):
                    oms.append(time_ms(theirs))
                    ms += [time_ms(mine), time_ms(mine)]
                    oms.append(time_ms(theirs))
                b_ms, by = level_bound_ms(m, t)
                row = dict(F=F, m=m, t=t,
                           cluster=kernels.fused_level_cluster(m, t),
                           ms=statistics.median(ms), ms_runs=ms,
                           other_ms=statistics.median(oms),
                           other_ms_runs=oms, bound_ms=b_ms, bound_by=by)
                for key in total:
                    total[key] += row[key]
                print(json.dumps(row), flush=True)
            per_iter[F] = total
    print(json.dumps({"card": card, "k1_ms_per_iteration": per_iter}),
          flush=True)


if __name__ == "__main__":
    main()
