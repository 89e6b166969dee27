"""Timing, bounds and level inputs shared by the port's on-card scripts.

``chip_smoke.py`` and ``omniswarm_torch.bench_level`` time kernels with
``time_ms``, state the least time the card could take with ``bound``, and
build fused-level (K1) inputs with ``random_level``.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from omniswarm_torch.solver.fused_level import (fused_reduction_level,
                                                fused_reduction_level_ref)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
LEVEL_RTOL = LEVEL_ATOL = 2e-4
# (F, m, level sizes t): the warm levels one LM iteration of the seed-0,
# 5-drone solve launches (pack 2 at F=100, pack 4 at F=1024)
SOLVE_LEVELS = ((100, 40, (32, 16, 8, 4)), (1024, 80, (128, 64, 32, 16, 8, 4)))


def time_ms(fn, reps: int = 21, calls: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: median over ``reps`` CUDA-event windows
    of ``calls`` back-to-back calls. Each window is queued behind a GPU
    sleep (~50 ms) long enough for a slow host to enqueue all its launches,
    so the host's launch latency does not open gaps between calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """(least ms, basis) for moving ``nbytes`` and doing ``ops`` FP32
    operations on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def level_bound_ms(m: int, t: int):
    """Least time for one level: 13 (m, m) f32 blocks moved and 18 m^3
    FLOPs per pair (9 block products)."""
    return bound(13 * m * m * 4 * t, 18 * m ** 3 * t)


def random_level(rng, Fl: int, m: int, branch: str):
    """SPD diagonal blocks, small couplings and a warm start: ``warm`` a
    perturbed true inverse, ``fallback`` 100*ones (trips the guard), ``nan``
    a true inverse with one NaN (the guard must see it)."""
    X = rng.normal(size=(Fl, m, m))
    A = X @ X.transpose(0, 2, 1) + 3.0 * np.eye(m)
    B = 0.25 * rng.normal(size=(Fl - 1, m, m))
    if branch == "fallback":
        X0 = 100.0 * np.ones((Fl // 2, m, m))
    else:
        X0 = np.linalg.inv(A[1::2]) * (1 + 1e-3)
        if branch == "nan":
            X0[0, 0, m - 1] = np.nan
    return [np.ascontiguousarray(v, np.float32) for v in (A, B, X0)]


def check_level(A, B, X0) -> float:
    """Max |kernel - plain| over the level's 7 outputs (through the wrapper,
    which counts a launch); raises past rtol = atol = 2e-4 or on a
    non-finite output."""
    names = ("Ainv", "B_left", "B_right", "W_l", "W_r", "A_new", "B_new")
    got = fused_reduction_level(A, B, X0)
    ref = fused_reduction_level_ref(A, B, X0)
    if A.is_cuda:
        torch.cuda.synchronize()
    err = 0.0
    for name, g, r in zip(names, got, ref):
        if g.numel() == 0 and g.shape == r.shape:   # B_new of one pair
            continue
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"K1 {name}: shape {tuple(g.shape)} or "
                               f"non-finite values")
        excess = float(((g - r).abs()
                        - (LEVEL_ATOL + LEVEL_RTOL * r.abs())).max())
        diff = float((g - r).abs().max())
        if excess > 0.0:
            raise RuntimeError(f"K1 {name} disagrees at m={A.shape[-1]} "
                               f"t={X0.shape[0]}: max |diff| {diff:.3e}")
        err = max(err, diff)
    return err
