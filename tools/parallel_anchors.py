#!/usr/bin/env python3
"""Reference anchors for the multi-device phase (10a) of ``chip_smoke.py``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/parallel_anchors.py

Runs the JAX package (the reference) on the CPU, on a virtual 8-device mesh
as the JAX tests do, and prints one JSON object to paste into
``chip_smoke.py``'s ``PARALLEL_ANCHORS``. Every solve runs with
``function_tolerance=0``:

- ``window_256``: ``lm_solve_bt_sharded`` (the frame-sharded window) on the
  multi-chip dryrun's problem (``__graft_entry__.py::dryrun_multichip``: 5
  drones x 256 frames, seed 2, ``loop_every=16``), 20 LM iterations, on
  meshes of 4 and 1 devices;
- ``fleet_100``: ``swarm_batch.lm_solve_multigraph`` on bench.py's fleet
  row: 8 lanes of 5 drones x 100 frames, seeds 100-107, loop capacity the
  largest lane's (at least 8), 20 LM iterations; each lane's cost;
- ``exact_1024``: ``lm_solve_bt(exact_linear=True)`` at 5 x 1024 (seed 0),
  50 LM iterations.

Wall seconds and peak RSS go to stderr.
"""
from __future__ import annotations

import json
import os
import resource
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402


def main() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from omniswarm_tpu import sim
    from omniswarm_tpu.parallel.sharded_window import lm_solve_bt_sharded
    from omniswarm_tpu.parallel.swarm_batch import (lm_solve_multigraph,
                                                    stack_graphs)
    from omniswarm_tpu.solver.dense import dense_graph_from_sim, lm_solve_bt

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    out = {}

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=256, seed=2,
                                      loop_every=16))
    graph = jax.device_put(dense_graph_from_sim(data))
    init = jnp.asarray(data.vio, jnp.float32)
    out["window_256"] = {}
    for n in (4, 1):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("frames",))
        res = lm_solve_bt_sharded(graph, init, mesh, max_iterations=20,
                                  function_tolerance=0.0)
        out["window_256"][f"world_{n}"] = float(res.cost)
    out["window_256"]["loops"] = len(data.loops)
    print(f"window_256 {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)

    sims = [sim.generate(sim.SimParams(num_drones=5, num_frames=100,
                                       seed=100 + k)) for k in range(8)]
    cap = max(8, max(len(d.loops) for d in sims))
    stacked = stack_graphs([dense_graph_from_sim(d, max_loops=cap)
                            for d in sims])
    inits = np.stack([np.asarray(d.vio, np.float32) for d in sims])
    res = lm_solve_multigraph(jax.device_put(stacked), jnp.asarray(inits),
                              max_iterations=20, function_tolerance=0.0)
    out["fleet_100"] = dict(cost=[float(c) for c in np.asarray(res.cost)],
                            loop_capacity=cap,
                            iterations=int(res.iterations))
    print(f"fleet_100 {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=1024, seed=0))
    res = lm_solve_bt(dense_graph_from_sim(data),
                      jnp.asarray(data.vio, jnp.float32), max_iterations=50,
                      function_tolerance=0.0, exact_linear=True)
    out["exact_1024"] = dict(cost=float(res.cost),
                             initial_cost=float(res.initial_cost),
                             loops=len(data.loops))
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"parallel_anchors {time.perf_counter() - t0:.1f} s, peak RSS "
          f"{rss_gb:.2f} GB", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
