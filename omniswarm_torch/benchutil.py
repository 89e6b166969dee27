"""Timing, bounds, counters and level inputs shared by the port's on-card
scripts.

``omniswarm_torch.bench_kernels`` times kernels with ``time_ms`` (inputs
warm in L2) and ``time_cold_ms`` (inputs read from HBM) and states the
least time the card could take with ``bound``; it, the ``cuda`` tests and
``chip_smoke.py`` build fused-level (K1) inputs with ``random_level`` at
the solves' level shapes (``SOLVE_LEVELS``). ``omniswarm_torch.bench``
(the counterpart of the root ``bench.py``) takes its constants,
``median_time``, ``pert``, the card's peaks (``card_peaks``) and the
operation counter ``count_ops`` from here; the tools of
``omniswarm_torch/tools/`` their problems (``sim_problem``), the card's
name and power limit (``card``), their timed solves (``measured_solve``)
and stage times (``chain``, ``nudge``, ``stage_ms``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from omniswarm_torch import sim
from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.solver.dense import dense_graph_from_sim
from omniswarm_torch.solver.fused_level import (fused_reduction_level,
                                                fused_reduction_level_ref)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
# bench.py:35-37: the reference's Ceres budget (<= 1000 iterations in
# max_solver_time 0.5 s, loop-5-drone.launch:36-38), the lanes of the
# multi-init batch and the headline's LM iterations
BUDGET_ANCHOR_ITER_PER_S = 2000.0
BATCH = 8
ITERS = 100
# Dense peaks (bf16 FLOP/s, device-memory bytes/s) by torch.cuda's card
# name: the H100 SXM with HBM3 (NVIDIA's data sheet, at 700 W). The
# efficiency fields of the bench are computed against these alone.
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12)}
ROOT = Path(__file__).resolve().parents[1]
LEVEL_RTOL = LEVEL_ATOL = 2e-4
# (F, D, m, level sizes t): the warm levels one LM iteration of a packed
# solve launches: 5 drones pack 2 at F=100 and 4 at F=1024; 10 drones pack
# 2 at F=1024 (512 blocks of 80). F=1024's dense-loop window (D=5) launches
# the D=5 row's levels; the window-scale sweep (D=5, pack 4) one level more
# a doubling of F, K1 at t = F/8 ... 4.
SOLVE_LEVELS = ((100, 5, 40, (32, 16, 8, 4)),
                (1024, 5, 80, (128, 64, 32, 16, 8, 4)),
                (1024, 10, 80, (256, 128, 64, 32, 16, 8, 4)),
                *((F, 5, 80, tuple(F // 8 >> k for k in range(n)))
                  for F, n in ((2048, 7), (4096, 8), (8192, 9), (16384, 10))))


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


def time_cold_ms(fn, inputs, **kw) -> float:
    """``time_ms`` of ``fn(x)`` with x cycling through ``inputs``: given
    distinct inputs larger than the 50 MB L2 in all, each call reads its
    input from device memory, not from L2."""
    it = itertools.cycle(inputs)
    return time_ms(lambda: fn(next(it)), **kw)


def bound(nbytes: float, ops: float):
    """(least ms, basis) for moving ``nbytes`` and doing ``ops`` FP32
    operations on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def level_work(m: int, t: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one level of t pairs: 13 (m, m) f32 blocks moved
    and 18 m^3 FLOPs per pair (9 block products)."""
    return 13 * m * m * 4 * t, 18 * m ** 3 * t


def level_bound_ms(m: int, t: int):
    """Least time for one level (``level_work`` on the card)."""
    return bound(*level_work(m, t))


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


def card(device) -> str:
    """``device``'s card as ``nvidia-smi --query-gpu=name,power.limit``
    prints it (its name and power limit), or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def sim_problem(dev, **params):
    """(sim data, device graph, f32 init on ``dev``, f32 init numpy) of
    ``sim.generate(SimParams(**params))``."""
    data = sim.generate(sim.SimParams(**params))
    init_np = np.asarray(data.vio, np.float32)
    return (data, dense_graph_to_torch(dense_graph_from_sim(data), dev),
            torch.from_numpy(init_np).to(dev), init_np)


def batch_inits(vio: np.ndarray, lanes: int = BATCH) -> np.ndarray:
    """bench.py:151-156's multi-init batch: lane 0 the VIO init, lanes 1..
    N(0, 0.4) added to the positions of every drone but the first, from
    numpy's default_rng(0)."""
    rng = np.random.default_rng(0)
    F, D = vio.shape[:2]
    inits = np.tile(np.asarray(vio, np.float32)[None], (lanes, 1, 1, 1))
    for b in range(1, lanes):
        inits[b, :, 1:, :3] += rng.normal(
            0, 0.4, size=(F, D - 1, 3)).astype(np.float32)
    return inits


def card_peaks(device) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, bytes/s) of ``device``'s card, or None (printed with
    the reason) for a card CARD_PEAKS does not list or the CPU."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = CARD_PEAKS.get(name)
    if peaks is None:
        print(f"[bench] no published peaks for {name!r} (CARD_PEAKS lists "
              f"{sorted(CARD_PEAKS)}): the efficiency fields are left out",
              flush=True)
    return peaks


def sync(x) -> None:
    """Wait for the device work behind the tensors in ``x``."""
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def median_time(fn, reps: int = 5):
    """(median wall seconds of ``fn(k)`` over k < reps, the last output),
    each rep ended by a synchronise (bench.py:88-103). ``fn`` makes each
    rep's inputs content-distinct with ``pert``, as the reference does."""
    ts, out = [], None
    for k in range(reps):
        t0 = time.perf_counter()
        out = fn(k)
        sync(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def measured_solve(solve, init_np: np.ndarray, dev, reps: int,
                   repeat: bool = False):
    """(result, readings) of a solver call ``solve(init)``, the tools'
    timing: the first solve of the unperturbed init, synchronised
    (``first_solve_s``), with the (m, t) of its K1 kernel launches
    (``k1_launches``, ``k1_levels`` as [m, t, count]); with ``repeat`` a
    second solve of the same init, ``repeat_equal`` when its cost and poses
    are bit-equal to the first's; then ``seconds``, the median over ``reps``
    ``pert``-perturbed inits (``median_time``), or with ``reps`` 0 the
    first solve's own time."""
    init = torch.from_numpy(init_np).to(dev)
    sync(init)
    with k1_levels() as levels:
        t0 = time.perf_counter()
        res = solve(init)
        sync(res.poses)
        first = time.perf_counter() - t0
    counts = collections.Counter(levels)
    out = dict(first_solve_s=first, k1_launches=len(levels),
               k1_levels=[[m, t, n] for (m, t), n in sorted(counts.items())])
    if repeat:
        again = solve(init)
        out["repeat_equal"] = bool(torch.equal(res.cost, again.cost)
                                   and torch.equal(res.poses, again.poses))
    if reps:
        inits = [torch.from_numpy(pert(init_np, k)).to(dev)
                 for k in range(reps)]
        out["seconds"] = median_time(lambda k: solve(inits[k]).poses,
                                     reps)[0]
    else:
        out["seconds"] = first
    return res, out


def chain(step, first):
    """A call that feeds ``step`` its own last output, from ``first`` on:
    the profile tools' data-dependent stage chains."""
    state = [first]

    def call():
        state[0] = step(state[0])
        return state[0]
    return call


def nudge(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A chain's next input: ``x`` moved by 1e-12 of a stage's output."""
    return x + 1e-12 * d.reshape(x.shape)


def stage_ms(name: str, fn, reps: int) -> float:
    """Synchronised host ms per call of ``fn()`` over ``reps`` back-to-back
    calls after one untimed call, printed beside ``name`` (the profile
    tools' stage times)."""
    sync(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(out)
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"{name:40s} {ms:9.3f} ms/call", flush=True)
    return ms


def pert(arr_np, k: int, eps: float = 1e-6) -> np.ndarray:
    """A copy of ``arr_np`` with its first element nudged by (k + 1) eps
    plus a draw below eps from numpy's global RNG (bench.py:106-113); the
    nudge never changes an iteration count."""
    out = np.array(arr_np, copy=True)
    out.reshape(-1)[0] += (k + 1) * eps + np.random.uniform(0, eps)
    return out


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; views
    and allocations move no data and are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.__name__.startswith("empty")):
            self.bytes += sum(x.numel() * x.element_size()
                              for x in tree_leaves((args, kwargs, out))
                              if isinstance(x, torch.Tensor))
        return out


@contextlib.contextmanager
def k1_levels():
    """Records the (m, t) of every K1 kernel launch (``kernels.fused_level``)
    into the list it yields; launches from the plain version are not
    kernel launches and are not recorded."""
    from omniswarm_torch import kernels

    launch, levels = kernels.fused_level, []

    def recording_launch(A, B, X0, guard):
        levels.append((A.shape[-1], A.shape[0] // 2))
        return launch(A, B, X0, guard)

    kernels.fused_level = recording_launch
    try:
        yield levels
    finally:
        kernels.fused_level = launch


def count_ops(fn):
    """(FLOPs, bytes, output) of one call of ``fn()``.

    FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products
    and convolutions: 2 per multiply-add) plus ``level_work``'s FLOPs for
    each K1 kernel launch. Bytes: each aten op's tensor inputs and outputs
    (views and allocations skipped) plus ``level_work``'s bytes for each K1
    launch. Neither counter sees a ``ctypes`` launch, hence K1's own count;
    K2 and K3, also ``ctypes`` launches, are not counted (neither is on the
    solver's path; K2's comparisons are no FLOPs). FlopCounterMode also
    leaves out element-wise ops, reductions, sorts and scatters and the
    factorizations (Cholesky, triangular solves). On the CPU the plain
    level runs as aten ops, which the counters see themselves.

    These count the port's eager program, op by op: every intermediate
    goes through memory. The reference's ``_hlo_cost`` (bench.py:67-86)
    counts XLA's fused program, whose fusions keep intermediates on chip,
    so the two are not the same quantity.
    """
    bytes_mode = _ByteCounter()
    flops_mode = FlopCounterMode(display=False)
    with k1_levels() as levels, flops_mode, bytes_mode:
        out = fn()
    sync(out)
    work = [level_work(m, t) for m, t in levels]
    return (flops_mode.get_total_flops() + sum(f for _, f in work),
            bytes_mode.bytes + sum(b for b, _ in work), out)


def refuse_reference_output(ap, path, patterns) -> None:
    """``ap.error`` (exit 2) when ``path`` is one of the repository's
    pre-port artifacts (a name matching one of ``patterns`` at its root) or
    lies inside one: an ``--out`` never overwrites them."""
    p = Path(path).resolve()
    if any(q.parent == ROOT and q.match(pattern)
           for q in (p, *p.parents) for pattern in patterns):
        ap.error(f"--out {path}: a reference artifact of the repository; "
                 f"write elsewhere")
