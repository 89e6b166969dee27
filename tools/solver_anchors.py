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

Each entry holds the final cost, the initial cost and the mean relative ATE
against the ground truth (per lane for the batch). About 2 minutes and
under 2 GB on one CPU core.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/solver_anchors.py --stall

instead solves F=384 (seed 0, D=5, 20 iterations) with the reference's fast
Woodbury path at pack 4 (its own choice), 2 and 1, its exact path and its
PCG, and prints their costs: the fast path stalls far above the other two.
"""
from __future__ import annotations

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


def main() -> None:
    import jax.numpy as jnp

    from omniswarm_tpu import sim
    from omniswarm_tpu.eval import metrics
    from omniswarm_tpu.solver import dense, gauss_newton

    kw = dict(max_iterations=20, function_tolerance=0.0)
    out = {}

    def record(name, res, gt, t0):
        cost = np.asarray(res.cost)
        poses = np.asarray(res.poses)
        ate = ([metrics.mean_relative_ate(p, gt) for p in poses]
               if cost.ndim else metrics.mean_relative_ate(poses, gt))
        out[name] = dict(cost=cost.tolist(),
                         initial_cost=np.asarray(res.initial_cost).tolist(),
                         iterations=int(res.iterations), relative_ate=ate,
                         seconds=round(time.perf_counter() - t0, 1))

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=1024, seed=0))
    t0 = time.perf_counter()
    record("pcg_1024", dense.lm_solve_bt(
        dense.dense_graph_from_sim(data), jnp.asarray(data.vio, jnp.float32),
        linear="pcg", **kw), data.gt, t0)

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=100, seed=0))
    graph = dense.dense_graph_from_sim(data)
    init = jnp.asarray(data.vio, jnp.float32)
    t0 = time.perf_counter()
    record("exact_100", dense.lm_solve_bt(graph, init, exact_linear=True,
                                          **kw), data.gt, t0)
    t0 = time.perf_counter()
    inits = perturbed_inits(data.vio, 8)
    record("batch_100", dense.lm_solve_bt_batched(
        graph, jnp.asarray(inits), **kw), data.gt, t0)
    t0 = time.perf_counter()
    res = dense.lm_solve_bt(graph, init, **kw)
    query = np.asarray([[99, d] for d in range(5)], np.int32)
    cov = np.asarray(dense.pose_covariances_jit(graph, res.poses,
                                                jnp.asarray(query)))
    out["cov_100"] = dict(query=query.tolist(),
                          diag=np.diagonal(cov, axis1=1, axis2=2).tolist(),
                          cost=float(res.cost),
                          seconds=round(time.perf_counter() - t0, 1))
    t0 = time.perf_counter()
    record("dense_100", dense.lm_solve_dense(graph, init, **kw), data.gt, t0)
    fg, finit = sim.build_graph_from_sim(data, enable_detections=True)
    t0 = time.perf_counter()
    record("generic_100", gauss_newton.lm_solve(fg, finit, **kw), data.gt, t0)
    t0 = time.perf_counter()
    record("multi_100", gauss_newton.lm_solve_multi_init(
        fg, jnp.asarray(inits[:4]), **kw), data.gt, t0)
    print(json.dumps(out))


if __name__ == "__main__":
    stall() if "--stall" in sys.argv[1:] else main()
