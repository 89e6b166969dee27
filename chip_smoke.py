#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. Every phase is fatal: any failure raises and the script exits
non-zero without printing a result.

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the port from csrc/ (one nvcc per source, started together).
2. Kernel phase: the fused cyclic-reduction level kernel against its plain
   PyTorch version on the card, at m=40 (t=32, the F=100 solve) and m=80
   (t=128, the F=1024 solve), on the warm branch and on the guard-fallback
   branch; rtol = atol = 2e-4 on all 7 outputs; CUDA-event medians of the
   kernel and of the plain version, beside the least time the card could
   take (bytes over 3.35 TB/s, FLOPs over 67 TFLOP/s FP32).
3. Main path: omniswarm_torch.entry.entry() at F=100, D=5, seed 0,
   20 LM iterations. Checks a finite cost below the initial one, within 1%
   of the reference's 177.25, relative ATE < 0.08, and 4 kernel launches per
   iteration; the same solve with fused=False must agree within 1e-3.
4. The same at F=1024 (pack 4, m=80, 6 launches per iteration), against
   the reference's 2330.99 and relative ATE < 0.1.
5. One JSON line with the kernels' numbers, then the result line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

RTOL = ATOL = 2e-4
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
MAIN_PATHS = (
    # F, launches per LM iteration, reference cost, relative-ATE bar
    (100, 4, 177.25, 0.08),
    (1024, 6, 2330.99, 0.1),
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int = 21, calls: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: median over ``reps`` CUDA-event windows
    of ``calls`` back-to-back calls. Each window is queued behind a GPU
    sleep (~50 ms) long enough for a slow host to enqueue all its launches,
    so the host's launch latency does not open gaps between calls."""
    import torch

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


def level_bound_ms(m: int, t: int):
    """Least time for one level: 13 (m, m) f32 blocks moved and 18 m^3
    FLOPs per pair (9 block products)."""
    nbytes = 13 * m * m * 4 * t
    flops = 18 * m ** 3 * t
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def random_level(rng, Fl: int, m: int, branch: str):
    """SPD diagonal blocks, small couplings and a warm start (``warm``: a
    perturbed true inverse; ``fallback``: 100*ones, which trips the guard)."""
    import numpy as np

    X = rng.normal(size=(Fl, m, m))
    A = X @ X.transpose(0, 2, 1) + 3.0 * np.eye(m)
    B = 0.25 * rng.normal(size=(Fl - 1, m, m))
    if branch == "warm":
        X0 = np.linalg.inv(A[1::2]) * (1 + 1e-3)
    else:
        X0 = 100.0 * np.ones((Fl // 2, m, m))
    return [np.ascontiguousarray(v, np.float32) for v in (A, B, X0)]


def kernel_phase():
    import numpy as np
    import torch

    from omniswarm_torch import kernels
    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    names = ("Ainv", "B_left", "B_right", "W_l", "W_r", "A_new", "B_new")
    rng = np.random.default_rng(0)
    rows = []
    with highp():
        for m, t in ((40, 32), (80, 128)):
            for branch in ("warm", "fallback"):
                A, B, X0 = (torch.from_numpy(v).cuda()
                            for v in random_level(rng, 2 * t, m, branch))
                got = fused_reduction_level(A, B, X0)
                ref = fused_reduction_level_ref(A, B, X0)
                torch.cuda.synchronize()
                err = 0.0
                for name, g, r in zip(names, got, ref):
                    check(g.shape == r.shape, f"{name} shape {g.shape}")
                    check(bool(torch.isfinite(g).all()), f"{name} not finite")
                    excess = (g - r).abs() - (ATOL + RTOL * r.abs())
                    check(float(excess.max()) <= 0.0,
                          f"kernel {name} disagrees at m={m} t={t} {branch}: "
                          f"max |diff| {float((g - r).abs().max()):.3e}")
                    err = max(err, float((g - r).abs().max()))
                bound, by = level_bound_ms(m, t)
                Bp = torch.cat([B, B.new_zeros((1, m, m))], 0)
                row = dict(
                    m=m, t=t, branch=branch, max_abs_err=err,
                    ms=time_ms(lambda: kernels.fused_level(A, Bp, X0, 0.95)),
                    wrapper_ms=time_ms(
                        lambda: fused_reduction_level(A, B, X0)),
                    plain_ms=time_ms(
                        lambda: fused_reduction_level_ref(A, B, X0)),
                    bound_ms=bound, bound_by=by)
                print("kernel fused_reduction_level", json.dumps(row),
                      flush=True)
                rows.append(row)
    return rows


def main_path_phase(F: int, per_iter: int, ref_cost: float, ate_bar: float):
    import torch

    from omniswarm_torch.entry import entry
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    iters = 20
    fused_reduction_level.launches = 0
    fused_reduction_level_ref.calls = 0
    res = entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                max_iterations=iters)
    launches = fused_reduction_level.launches
    check(fused_reduction_level_ref.calls == 0,
          "the plain level ran on the card path")
    print(f"main path F={F} D=5: loops {res.num_loops} detections "
          f"{res.num_detections} cost {res.initial_cost:.4f} -> "
          f"{res.cost:.4f} (reference {ref_cost}) iterations "
          f"{res.iterations} rel ATE {res.relative_ate:.5f} (VIO "
          f"{res.vio_relative_ate:.5f}) K1 launches {launches} solve "
          f"{res.solve_s * 1e3:.1f} ms = "
          f"{res.solve_s * 1e3 / res.iterations:.2f} ms/iteration",
          flush=True)
    check(res.poses.shape == (F, 5, 4), f"poses shape {res.poses.shape}")
    check(bool(torch.isfinite(torch.as_tensor(res.poses)).all()),
          "poses not finite")
    check(math.isfinite(res.cost) and res.cost < res.initial_cost,
          f"cost {res.cost} not below initial {res.initial_cost}")
    check(abs(res.cost - ref_cost) <= 0.01 * ref_cost,
          f"cost {res.cost} not within 1% of {ref_cost}")
    check(res.relative_ate < ate_bar,
          f"relative ATE {res.relative_ate} >= {ate_bar}")
    check(res.iterations == iters, f"{res.iterations} iterations run")
    check(launches == per_iter * res.iterations,
          f"{launches} K1 launches, expected {per_iter * res.iterations}")

    unfused = entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                    max_iterations=iters, fused=False)
    rel = abs(unfused.cost - res.cost) / abs(unfused.cost)
    print(f"main path F={F} fused=False: cost {unfused.cost:.4f} rel delta "
          f"{rel:.3e} solve {unfused.solve_s * 1e3 / unfused.iterations:.2f}"
          f" ms/iteration", flush=True)
    check(unfused.k1_launches == 0, "fused=False launched the kernel")
    check(rel <= 1e-3, f"fused and unfused costs differ by {rel:.3e}")
    return dict(F=F, cost=res.cost, initial_cost=res.initial_cost,
                iterations=res.iterations, relative_ate=res.relative_ate,
                launches=launches,
                ms_per_iteration=res.solve_s * 1e3 / res.iterations,
                unfused_cost=unfused.cost,
                unfused_ms_per_iteration=(unfused.solve_s * 1e3
                                          / unfused.iterations))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from omniswarm_torch import kernels
    except ImportError:
        print("chip_smoke: run from the repository root (omniswarm_torch "
              "not found)", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    build_s = kernels.build()
    print(f"kernel build {build_s:.2f} s", flush=True)
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    rows = kernel_phase()
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", flush=True)

    # warm-up: library handles and allocator, outside the counted run
    from omniswarm_torch.entry import entry
    entry(device="cuda", max_iterations=2)

    paths = {}
    for F, per_iter, ref_cost, ate_bar in MAIN_PATHS:
        t0 = time.perf_counter()
        paths[F] = main_path_phase(F, per_iter, ref_cost, ate_bar)
        print(f"main path F={F} phase {time.perf_counter() - t0:.1f} s",
              flush=True)

    main = next(r for r in rows if (r["m"], r["branch"]) == (40, "warm"))
    kernels_line = {"kernels": [{
        "name": "fused_reduction_level",
        "route": "cuda",
        "source": "omniswarm_torch/csrc/fused_level.cu",
        "replaces": "omniswarm_tpu/solver/pallas_level.py:89 "
                    "fused_reduction_level",
        "launches": paths[100]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "wrapper_ms": main["wrapper_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "launches_f1024": paths[1024]["launches"],
        "shapes": rows,
        "main_paths": list(paths.values()),
    }]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
