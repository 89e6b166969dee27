"""``python -m omniswarm_torch.tools.bench_dense_loops`` against the JAX
package's ``lm_solve_bt``: every run of the tool (PCG at 24/16/12/8 CG
sweeps, the Woodbury path and, with ``--exact``, the exact path) on a small
loop-dense window on the CPU, each held to the reference's solve on the
same linear path."""
import jax.numpy as jnp
import numpy as np
import torch

from omniswarm_torch.tools import bench_dense_loops
from omniswarm_tpu import sim
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
ITERS = 3


# A PCG solve of few sweeps far from its minimum splits on rounding (the
# reference's own fused and XLA level branches split by 1.1% at F=1024,
# PERF.md §6): on this problem the port's PCG costs lie up to 6.5e-4 from
# the reference's (16 sweeps), so the bar is 2e-3; the Woodbury and exact
# rows lie within 5e-5.
PCG_RTOL = 2e-3


def test_dense_loops_rows_match_jax():
    """Every run of the tool at F=128 (``--loop-every 8``: 78 loops), each
    held to the reference's solve with the same linear path."""
    res = bench_dense_loops.measure("cpu", frames=128, loop_every=8,
                                    iters=ITERS, reps=0, exact=True)
    data = sim.generate(sim.SimParams(num_drones=5, num_frames=128, seed=4,
                                      loop_every=8))
    graph = jdense.dense_graph_from_sim(data)
    assert res["loops"] == len(data.loops)
    for key, kw in bench_dense_loops.runs(exact=True).items():
        ref = jdense.lm_solve_bt(graph, jnp.asarray(data.vio, jnp.float32),
                                 max_iterations=ITERS,
                                 function_tolerance=0.0, **kw)
        row = res[key]
        np.testing.assert_allclose(
            row["final_cost"], float(ref.cost), err_msg=key,
            rtol=PCG_RTOL if kw.get("linear") == "pcg" else 1e-3)
        np.testing.assert_allclose(row["initial_cost"],
                                   float(ref.initial_cost), rtol=1e-5)
        assert {"ms_per_iter", "iter_per_s", "final_cost"} <= set(row)
    for n in bench_dense_loops.CG_ITERS:
        row = res[f"pcg_cg{n}"]
        for truth in ("smw", "exact"):
            np.testing.assert_allclose(
                row[f"cost_vs_{truth}"],
                (row["final_cost"] - res[truth]["final_cost"])
                / res[truth]["final_cost"])
