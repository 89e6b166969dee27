"""Port vs reference: the factor-sharded LM (tests/test_sharded_solver.py's
problem: D=4, F=24, seed 7, detections on) and the axis mode of the dense
gold path, on gloo ranks spawned on the CPU, against the JAX package's
single-device solves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.convert import dense_graph_to_torch, factor_graph_to_torch
from omniswarm_torch.eval import metrics
from omniswarm_torch.parallel.launch import call_each, run_ranks, to_host
from omniswarm_tpu import sim
from omniswarm_tpu.solver import dense as jdense
from omniswarm_tpu.solver import gauss_newton as jgn

torch.set_num_threads(1)
MOD = "omniswarm_torch.parallel.sharded_solver"


def port_graph(graph):
    """The port's FactorGraph with numpy leaves (the ranks import no JAX)."""
    return to_host(factor_graph_to_torch(graph, "cpu"))


@pytest.fixture(scope="module")
def problem():
    data = sim.generate(sim.SimParams(num_drones=4, num_frames=24, seed=7))
    graph, init = sim.build_graph_from_sim(data, enable_detections=True)
    return data, graph, np.asarray(init, np.float32)


@pytest.fixture(scope="module")
def runs(problem):
    """Every case inside one spawn of 4 gloo ranks (world 2 in blocks)."""
    data, graph, init = problem
    big = sim.generate(sim.SimParams(num_drones=10, num_frames=16, seed=9))
    bgraph, binit = sim.build_graph_from_sim(big, enable_detections=True)
    dense = to_host(dense_graph_to_torch(jdense.dense_graph_from_sim(data),
                                         "cpu"))
    calls = [(f"{MOD}:sharded_lm_solve",
              dict(graph=port_graph(graph), poses0=init, max_iterations=40)),
             (f"{MOD}:sharded_lm_solve",
              dict(graph=port_graph(graph), poses0=init, max_iterations=40),
              2),
             (f"{MOD}:sharded_lm_solve",
              dict(graph=port_graph(bgraph), poses0=np.asarray(binit),
                   max_iterations=30)),
             (f"{MOD}:sharded_lm_solve_dense",
              dict(graph=dense, poses0=init, max_iterations=40))]
    ranks = run_ranks(call_each, 4, backend="gloo", device="cpu",
                      args=(calls,), timeout_s=300)
    for r in ranks[1:]:                  # every rank returns the same result
        for a, b in zip(r, ranks[0]):
            assert float(a["result"].cost) == float(b["result"].cost)
            np.testing.assert_array_equal(a["result"].poses,
                                          b["result"].poses)
    return dict(zip(("main", "subset", "ten", "dense"), ranks[0]), big=big)


@pytest.fixture(scope="module")
def reference(problem):
    _, graph, init = problem
    return jgn.lm_solve(graph, jnp.asarray(init), max_iterations=40)


@pytest.mark.parametrize("case", ["main", "subset"],
                         ids=["world4", "world2"])
def test_sharded_matches_single_device(runs, reference, case):
    res = runs[case]["result"]
    np.testing.assert_allclose(float(res.cost), float(reference.cost),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.poses, np.asarray(reference.poses),
                               atol=5e-3)


def test_sharded_accuracy(problem, runs):
    data = problem[0]
    assert metrics.mean_relative_ate(runs["main"]["result"].poses,
                                     data.gt) < 0.1


def test_ten_drone_sharded_scaling(runs):
    res = runs["ten"]["result"]
    assert np.isfinite(float(res.cost))
    assert metrics.mean_relative_ate(res.poses, runs["big"].gt) < 0.15


def test_dense_axis_mode_matches_lm_solve_dense(problem, runs):
    data, _, init = problem
    ref = jdense.lm_solve_dense(jdense.dense_graph_from_sim(data),
                                jnp.asarray(init), max_iterations=40)
    res = runs["dense"]["result"]
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-3)
    np.testing.assert_allclose(res.poses, np.asarray(ref.poses), atol=5e-3)
    assert runs["dense"]["kernels"]["k1"] == 0
