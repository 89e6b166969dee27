"""Port vs reference: the fleet lanes (tests/test_swarm_batch.py's fleet: 8
lanes of 3 drones x 16 frames, seeds 100-107, loop capacity 32), unsplit in
this process and split over 4 gloo ranks spawned on the CPU, against the
JAX package's solve_fleet and the port's single lm_solve_bt of each
lane."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.eval import metrics
from omniswarm_torch.parallel.launch import call_each, run_ranks, to_host
from omniswarm_torch.parallel.swarm_batch import solve_fleet
from omniswarm_torch.solver import dense as tdense
from omniswarm_tpu import sim
from omniswarm_tpu.parallel import swarm_batch as jfleet
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
SOLVE = "omniswarm_torch.parallel.swarm_batch:solve_fleet"
ITERS = 40


@pytest.fixture(scope="module")
def fleet():
    datas, graphs, inits = [], [], []
    for seed in range(8):
        data = sim.generate(sim.SimParams(num_drones=3, num_frames=16,
                                          seed=100 + seed))
        graphs.append(jdense.dense_graph_from_sim(data, max_loops=32))
        inits.append(np.asarray(data.vio, np.float32))
        datas.append(data)
    port = [to_host(dense_graph_to_torch(g, "cpu")) for g in graphs]
    return datas, graphs, port, inits


@pytest.fixture(scope="module")
def runs(fleet):
    """8 lanes (2 a rank) and 6 lanes (replicated) in one spawn of 4."""
    _, _, port, inits = fleet
    calls = [(SOLVE, dict(graphs=port[:n], inits=inits[:n],
                          max_iterations=ITERS)) for n in (8, 6)]
    ranks = run_ranks(call_each, 4, backend="gloo", device="cpu",
                      args=(calls,), timeout_s=300)
    for r in ranks[1:]:                  # every rank returns every lane
        for a, b in zip(r, ranks[0]):
            np.testing.assert_array_equal(a["result"].cost,
                                          b["result"].cost)
            np.testing.assert_array_equal(a["result"].poses,
                                          b["result"].poses)
    return ranks[0]


@pytest.fixture(scope="module")
def references(fleet):
    datas, graphs, port, inits = fleet
    jax_res = jfleet.solve_fleet(
        graphs, [jnp.asarray(i) for i in inits], max_iterations=ITERS,
        mesh=Mesh(np.asarray(jax.devices()[:8]), ("fleet",)))
    singles = [float(tdense.lm_solve_bt(g, i, device="cpu",
                                        max_iterations=ITERS).cost)
               for g, i in zip(port, inits)]
    return np.asarray(jax_res.cost), singles


def check_lanes(res, datas, references, lanes):
    jax_cost, singles = references
    assert res.poses.shape[0] == len(lanes)
    for b in lanes:
        cost = float(res.cost[b])
        np.testing.assert_allclose(cost, jax_cost[b], rtol=0.05, atol=0.5)
        np.testing.assert_allclose(cost, singles[b], rtol=0.05, atol=0.5)
        assert metrics.mean_relative_ate(np.asarray(res.poses[b]),
                                         datas[b].gt) < 0.1


@pytest.fixture(scope="module")
def unsplit(fleet):
    return solve_fleet(fleet[2], fleet[3], device="cpu",
                       max_iterations=ITERS)


def test_fleet_unsplit_matches_individual_solves(fleet, references,
                                                 unsplit):
    check_lanes(unsplit, fleet[0], references, range(8))


def test_fleet_split_over_ranks(fleet, runs, references, unsplit):
    check_lanes(runs[0]["result"], fleet[0], references, range(8))
    # split lanes solve as they do unsplit; iterations are the lock-step
    # count over all lanes
    np.testing.assert_allclose(runs[0]["result"].cost, unsplit.cost.numpy(),
                               rtol=1e-5)
    assert runs[0]["result"].iterations == unsplit.iterations


def test_fleet_replicated_when_lanes_do_not_divide(fleet, runs, references):
    call = runs[1]
    check_lanes(call["result"], fleet[0], references, range(6))
    assert call["counts"] == {}          # every rank solved all 6 lanes
