#!/usr/bin/env python3
"""Reference anchors for the solver phases of ``chip_smoke.py``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/solver_anchors.py

Runs the JAX package (the reference) on the CPU on the chip check's problems
and prints one JSON object to paste into ``chip_smoke.py``'s
``SOLVER_ANCHORS``. Every solve runs 20 LM iterations with
``function_tolerance=0``, on ``sim.generate(SimParams(num_drones=5,
num_frames=F, seed=0))``:

- ``pcg_1024``: ``lm_solve_bt(linear="pcg")`` at F=1024 (24 CG sweeps);
- ``exact_100``: ``lm_solve_bt(exact_linear=True)`` at F=100;
- ``batch_100``: ``lm_solve_bt_batched`` at F=100 on bench.py's 8 inits
  (VIO, then VIO plus N(0, 0.4) on the non-self positions of lanes 1-7,
  ``numpy.random.default_rng(0)``);
- ``cov_100``: the diagonals of ``pose_covariances`` at the F=100
  ``lm_solve_bt`` solution, for the newest frame of each drone;
- ``dense_100``: ``lm_solve_dense`` on ``dense_graph_from_sim``;
- ``generic_100`` and ``multi_100``: ``lm_solve`` and
  ``lm_solve_multi_init`` (the first 4 of the inits above) on
  ``build_graph_from_sim(enable_detections=True)``.

and for phase 13a (the 10-drone tier and the loop-dense window):

- ``d10_100``: bench.py's 10-drone row (:340-358), ``lm_solve_bt`` at 10 x
  100, seed 3, 50 iterations (the Woodbury path at pack 1);
- ``d10_1024``: ``lm_solve_bt`` at 10 x 1024, seed 0, 20 iterations (PCG
  by the "auto" rule, pack 2: 80-wide blocks);
- ``dense_loops_1024``: bench.py's loop-dense serving window (:307-337),
  5 x 1024, seed 4, ``loop_every=2`` (2,555 loops), 25 iterations: PCG by
  the "auto" rule at ``cg_iters`` 24, 16, 12 and 8 (``pcg24`` ...
  ``pcg8``) and ``exact_linear=True`` (``exact``), the ground truth.

The phase 13a entries run the reference's ``bt_factor`` on its TPU branch
(``reference_fused_levels``): the warm levels of a packed solve go through
its fused Pallas level, in interpret mode on the CPU, as they go through K1
on the card. Its CPU branch (XLA levels, the same arithmetic rounded
otherwise) splits from it on the loop-dense window at 8 CG sweeps, an
inexact solve far from its minimum: 4398.60 against 4449.52 after 25
iterations (the port: 4448.79 on the card through K1, 4394.12 on the CPU
with ``fused=False``); at 24 sweeps the two lie 3.6e-5 apart.

Each entry holds the final cost, the initial cost and the mean relative ATE
against the ground truth (per lane for the batch), and raw VIO's relative
ATE for the phase 13a entries. ``--only NAME ...`` runs the named entries
alone. Phase 13a's entries (``--only d10_100 d10_1024 dense_loops_1024``)
take about 30 minutes and 7.5 GB peak RSS on an 8-core CPU, 25 of those
minutes the exact dense-loop solve, whose capacitance has 10,220 columns.

``window_scale`` (phase 15a, ``--only window_scale [--frames F ...]``):
``python -m omniswarm_torch.tools.window_scale_sweep``'s problems, 5 x F
for F in 1,024 ... 16,384 (seed 1, ``loop_every=128``, 25 iterations,
``function_tolerance=0``; Woodbury up to F=4,096, PCG by the "auto" rule
above), on the fused-level branch as phase 13a's; each entry also holds
its linear path, the simulation's and the solve's seconds and the peak RSS
of the process so far (``peak_rss_gb``: run one F a process to read each
size's own). On an 8-core CPU F = 1,024 ... 8,192 took 29-1,452 s of
solve beside other jobs and F = 16,384 2,770 s alone (2.5 GB peak RSS).

``replay`` (phase 15a, ``--only replay``): the reference's
``tools/replay_eval.py`` (its estimator on the CPU) on CSV flight logs that
``omniswarm_torch.tools.replay_eval.write_sim_logs`` writes from the
simulator (3 drones, 30 s at 50 Hz, seed 0; offsets 0, 2 and 4 s), with
``--loops`` and the tool's defaults (40 keyframe periods of 0.5 s, a solve
every 10th) but ``max_solver_time`` 1e-6 s, so that every solve after the
second gets the estimator's least iteration budget (25) on any host: each
solve's status (window size, cost, iterations) and the report's
``summary.json``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/solver_anchors.py --stall

instead solves F=384 (seed 0, D=5, 20 iterations) with the reference's fast
Woodbury path at pack 4 (its own choice), 2 and 1, its exact path and its
PCG, and prints their costs: the fast path stalls far above the other two.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np


def perturbed_inits(vio: np.ndarray, lanes: int) -> np.ndarray:
    """bench.py's batch inits: lane 0 VIO, lanes 1.. VIO + N(0, 0.4) on the
    positions of every drone but the first."""
    rng = np.random.default_rng(0)
    F, D = vio.shape[:2]
    inits = np.tile(np.asarray(vio, np.float32)[None], (lanes, 1, 1, 1))
    for b in range(1, lanes):
        inits[b, :, 1:, :3] += rng.normal(
            0, 0.4, size=(F, D - 1, 3)).astype(np.float32)
    return inits


def stall() -> None:
    import jax.numpy as jnp

    from omniswarm_tpu import sim
    from omniswarm_tpu.solver import dense

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=384, seed=0))
    graph = dense.dense_graph_from_sim(data)
    init = jnp.asarray(data.vio, jnp.float32)
    runs = dict(smw_pack4=dict(linear="smw"),
                smw_pack2=dict(linear="smw", pack=2),
                smw_pack1=dict(linear="smw", pack=1),
                exact=dict(exact_linear=True), pcg=dict(linear="pcg"))
    out = {}
    for name, kw in runs.items():
        res = dense.lm_solve_bt(graph, init, max_iterations=20,
                                function_tolerance=0.0, **kw)
        out[name] = dict(cost=float(res.cost), lam=float(res.lam))
    print(json.dumps(out))


def summary(res, gt, t0, vio=None) -> dict:
    """A solve's final and initial cost, iterations, relative ATE (per lane
    for a batch; and raw VIO's with ``vio``) and seconds since ``t0``."""
    from omniswarm_tpu.eval import metrics

    cost = np.asarray(res.cost)
    poses = np.asarray(res.poses)
    ate = ([metrics.mean_relative_ate(p, gt) for p in poses]
           if cost.ndim else metrics.mean_relative_ate(poses, gt))
    out = dict(cost=cost.tolist(),
               initial_cost=np.asarray(res.initial_cost).tolist(),
               iterations=int(res.iterations), relative_ate=ate)
    if vio is not None:
        out["vio_relative_ate"] = metrics.mean_relative_ate(vio, gt)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


@contextlib.contextmanager
def reference_fused_levels():
    """The reference's ``bt_factor`` takes its TPU branch on the CPU: warm
    levels of packed solves through ``pallas_level.fused_reduction_level``,
    which runs in interpret mode off the TPU."""
    import jax

    from omniswarm_tpu.solver import block_tridiag

    class TPUBackend:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def default_backend():
            return "tpu"

    block_tridiag.jax = TPUBackend()
    try:
        yield
    finally:
        block_tridiag.jax = jax


def tier10(out: dict, only) -> None:
    """Phase 13a's entries (see the module docstring) into ``out``."""
    import jax.numpy as jnp

    from omniswarm_tpu import sim
    from omniswarm_tpu.solver import dense

    def solve(params, iters, **kw):
        data = sim.generate(params)
        t0 = time.perf_counter()
        res = dense.lm_solve_bt(
            dense.dense_graph_from_sim(data),
            jnp.asarray(data.vio, jnp.float32), max_iterations=iters,
            function_tolerance=0.0, **kw)
        rec = summary(res, data.gt, t0, data.vio)
        rec["loops"] = len(data.loops)
        return rec

    if "d10_100" in only:
        out["d10_100"] = solve(sim.SimParams(
            num_drones=10, num_frames=100, seed=3), 50)
    if "d10_1024" in only:
        out["d10_1024"] = solve(sim.SimParams(
            num_drones=10, num_frames=1024, seed=0), 20)
    if "dense_loops_1024" in only:
        params = sim.SimParams(num_drones=5, num_frames=1024, seed=4,
                               loop_every=2)
        runs = {f"pcg{n}": dict(cg_iters=n) for n in (24, 16, 12, 8)}
        runs["exact"] = dict(exact_linear=True)
        out["dense_loops_1024"] = {
            name: solve(params, 25, **kw) for name, kw in runs.items()}


WINDOW_FRAMES = (1024, 2048, 4096, 8192, 16384)


def peak_rss_gb() -> float:
    """The process's peak resident set so far, GB (Linux: ru_maxrss KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def window_scale(out: dict, frames) -> None:
    """The window-scale sweep's entries (see the module docstring) into
    ``out["window_scale"]``, keyed by F."""
    import jax.numpy as jnp

    from omniswarm_tpu import sim
    from omniswarm_tpu.solver import dense

    rows = out.setdefault("window_scale", {})
    for F in frames:
        t0 = time.perf_counter()
        data = sim.generate(sim.SimParams(num_drones=5, num_frames=F,
                                          seed=1, loop_every=128))
        graph = dense.dense_graph_from_sim(data)
        sim_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = dense.lm_solve_bt(graph, jnp.asarray(data.vio, jnp.float32),
                                max_iterations=25, function_tolerance=0.0)
        rec = summary(res, data.gt, t0, data.vio)
        rec.update(loops=len(data.loops),
                   linear=("pcg" if F > 4096 or 4 * graph.loops.valid.shape[0]
                           > 4096 else "smw"),
                   sim_seconds=round(sim_s, 1), peak_rss_gb=peak_rss_gb())
        rows[str(F)] = rec
        print(f"window_scale F={F}: {json.dumps(rec)}", file=sys.stderr,
              flush=True)


REPLAY_LOGS = dict(drones=3, seconds=30.0, seed=0)
REPLAY_OFFSETS = (0.0, 2.0, 4.0)


def replay(out: dict) -> None:
    """The replay entry (see the module docstring) into ``out``."""
    import functools
    import os
    import tempfile

    from omniswarm_tpu import config
    from omniswarm_tpu.swarm import estimator
    from omniswarm_torch.tools.replay_eval import write_sim_logs

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import replay_eval as reference

    solves, solve = [], estimator.SwarmEstimator.solve

    def recording_solve(self, *args, **kw):
        solves.append(solve(self, *args, **kw))
        return solves[-1]

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_sim_logs(tmp, **REPLAY_LOGS)
        argv = ["replay_eval.py", "--logs",
                *(f"{p}:{o}" for p, o in zip(paths, REPLAY_OFFSETS)),
                "--loops", "--out", os.path.join(tmp, "report")]
        t0 = time.perf_counter()
        estimator.SwarmEstimator.solve = recording_solve
        params = config.SolverParams     # the reference imports it late
        config.SolverParams = functools.partial(params, max_solver_time=1e-6)
        saved, sys.argv = sys.argv, argv
        try:
            reference.main()
        finally:
            estimator.SwarmEstimator.solve = solve
            config.SolverParams = params
            sys.argv = saved
        with open(os.path.join(tmp, "report", "summary.json")) as f:
            summary = json.load(f)
    out["replay"] = dict(
        solves=[{k: s[k] for k in ("solved", "num_frames", "cost",
                                   "iterations") if k in s} for s in solves],
        summary=summary, seconds=round(time.perf_counter() - t0, 1),
        peak_rss_gb=peak_rss_gb())


TIER10 = ("d10_100", "d10_1024", "dense_loops_1024")
BASE = ("pcg_1024", "exact_100", "batch_100", "cov_100", "dense_100",
        "generic_100", "multi_100")


def base(out: dict, only) -> None:
    """The earlier phases' entries (see the module docstring) into ``out``."""
    import jax.numpy as jnp

    from omniswarm_tpu import sim
    from omniswarm_tpu.solver import dense, gauss_newton

    kw = dict(max_iterations=20, function_tolerance=0.0)

    def record(name, solve, gt):
        if name in only:
            t0 = time.perf_counter()
            out[name] = summary(solve(), gt, t0)

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=1024, seed=0))
    record("pcg_1024", lambda: dense.lm_solve_bt(
        dense.dense_graph_from_sim(data), jnp.asarray(data.vio, jnp.float32),
        linear="pcg", **kw), data.gt)

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=100, seed=0))
    graph = dense.dense_graph_from_sim(data)
    init = jnp.asarray(data.vio, jnp.float32)
    inits = perturbed_inits(data.vio, 8)
    record("exact_100", lambda: dense.lm_solve_bt(
        graph, init, exact_linear=True, **kw), data.gt)
    record("batch_100", lambda: dense.lm_solve_bt_batched(
        graph, jnp.asarray(inits), **kw), data.gt)
    if "cov_100" in only:
        t0 = time.perf_counter()
        res = dense.lm_solve_bt(graph, init, **kw)
        query = np.asarray([[99, d] for d in range(5)], np.int32)
        cov = np.asarray(dense.pose_covariances_jit(graph, res.poses,
                                                    jnp.asarray(query)))
        out["cov_100"] = dict(query=query.tolist(),
                              diag=np.diagonal(cov, axis1=1,
                                               axis2=2).tolist(),
                              cost=float(res.cost),
                              seconds=round(time.perf_counter() - t0, 1))
    record("dense_100", lambda: dense.lm_solve_dense(graph, init, **kw),
           data.gt)
    fg, finit = sim.build_graph_from_sim(data, enable_detections=True)
    record("generic_100", lambda: gauss_newton.lm_solve(fg, finit, **kw),
           data.gt)
    record("multi_100", lambda: gauss_newton.lm_solve_multi_init(
        fg, jnp.asarray(inits[:4]), **kw), data.gt)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--stall", action="store_true")
    ap.add_argument("--only", nargs="+",
                    choices=BASE + TIER10 + ("window_scale", "replay"),
                    default=BASE + TIER10)
    ap.add_argument("--frames", nargs="+", type=int, default=WINDOW_FRAMES,
                    help="the window_scale entry's sizes")
    args = ap.parse_args(argv)
    if args.stall:
        stall()
        return
    out = {}
    if set(args.only) & set(BASE):
        base(out, args.only)
    if "replay" in args.only:
        replay(out)
    with reference_fused_levels():
        tier10(out, args.only)
        if "window_scale" in args.only:
            window_scale(out, args.frames)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
