"""Port vs reference: the frame-sharded window LM
(tests/test_sharded_window.py's problem: D=4, F=48, seed 2) on gloo ranks
spawned on the CPU, against the port's single-process assembly and exact
lm_solve_bt and the JAX package's sharded assembly and solves on meshes of
as many virtual devices."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.parallel.launch import call_each, run_ranks, to_host
from omniswarm_torch.solver import dense as tdense
from omniswarm_tpu import sim
from omniswarm_tpu.parallel import sharded_window as jwin
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
MOD = "omniswarm_torch.parallel.sharded_window"
WORLDS = (4, 2)
ITERS = 30
F_CUT = 45


def cut_frames(graph, F):
    """The first F frames of a DenseGraph, loops past them invalid
    (tests/test_sharded_window.py::test_sharded_lm_padding_path) and
    pointed at frame F-1 (a torch index past the poses raises)."""
    odom = slice(0, F - 1)
    lp = graph.loops
    return graph._replace(
        range_dist=graph.range_dist[:F], range_valid=graph.range_valid[:F],
        odom_dpose=graph.odom_dpose[odom],
        odom_sqrt_info=graph.odom_sqrt_info[odom],
        odom_valid=graph.odom_valid[odom],
        det_dir=graph.det_dir[:F], det_tb=graph.det_tb[:F],
        det_invdep=graph.det_invdep[:F], det_valid=graph.det_valid[:F],
        det_has_depth=graph.det_has_depth[:F],
        pose_valid=graph.pose_valid[:F], pose_fixed=graph.pose_fixed[:F],
        yaw_fixed=graph.yaw_fixed[:F],
        loops=lp._replace(
            valid=lp.valid & (lp.frame_a < F) & (lp.frame_b < F),
            frame_a=np.minimum(lp.frame_a, F - 1),
            frame_b=np.minimum(lp.frame_b, F - 1)))


@pytest.fixture(scope="module")
def problem():
    data = sim.generate(sim.SimParams(num_drones=4, num_frames=48, seed=2))
    jg = jdense.dense_graph_from_sim(data)
    # the ranks get the port's container with numpy leaves (no JAX there)
    return data, jg, to_host(dense_graph_to_torch(jg, "cpu"))


@pytest.fixture(scope="module")
def runs(problem):
    """Every case inside one spawn of 4 gloo ranks (world 2 in blocks)."""
    data, _, pg = problem
    vio = np.asarray(data.vio, np.float32)
    calls = [(f"{MOD}:sharded_normal_equations", dict(graph=pg, poses=vio))]
    calls += [(f"{MOD}:lm_solve_bt_sharded",
               dict(graph=pg, poses0=vio, max_iterations=ITERS), world)
              for world in WORLDS]
    calls.append((f"{MOD}:lm_solve_bt_sharded",
                  dict(graph=cut_frames(pg, F_CUT), poses0=vio[:F_CUT],
                       max_iterations=20)))
    ranks = run_ranks(call_each, 4, backend="gloo", device="cpu",
                      args=(calls,), timeout_s=300)
    return dict(assembly=[r[0]["result"] for r in ranks],
                solve={w: [r[1 + i] for r in ranks]
                       for i, w in enumerate(WORLDS)},
                padded=[r[-1] for r in ranks])


def jax_mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("frames",))


@pytest.fixture(scope="module")
def jax_assembly(problem):
    """The reference's _assemble_sharded on 4 devices, concatenated."""
    data, jg, _ = problem
    g4, poses4, _ = jwin.pad_graph_frames(
        jg, jnp.asarray(data.vio, jnp.float32), 4)

    def body(g, poses):
        A, B, gf, U, cost, _ = jwin._assemble_sharded(
            g, poses, axis="frames", huber_delta=1.0, det_sphere_std=0.1,
            det_inv_dep_std=0.5)
        return A, B, gf, U, cost[None]

    fn = jax.jit(jax.shard_map(
        body, mesh=jax_mesh(4), in_specs=(jwin._graph_specs(g4, "frames"),
                                          P("frames")),
        out_specs=(P("frames"),) * 5, check_vma=False))
    return [np.asarray(x) for x in fn(g4, poses4)]


@pytest.mark.parametrize("part", range(5), ids=["A", "B", "g", "U", "cost"])
def test_sharded_assembly_matches_dense(problem, runs, jax_assembly, part):
    data, _, pg = problem
    got = [np.asarray(r[part]) for r in runs["assembly"]]
    got = np.sum(got) if part == 4 else np.concatenate(got)
    A, B, g, U, cost = tdense.assemble_blocks(
        dense_graph_to_torch(pg, "cpu"),
        torch.from_numpy(np.asarray(data.vio, np.float32)))
    want = [A, B, g, U, cost][part].numpy()
    ref = jax_assembly[part]
    if part == 1:                # the last rank's coupling row is zero
        assert not np.any(got[-1]) and not np.any(ref[-1])
        got, ref = got[:-1], ref[:-1]
    if part == 4:
        ref = np.sum(ref)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def references(problem):
    """The reference's exact lm_solve_bt and its frame-sharded solve on 4
    devices (one compile each), and the port's exact lm_solve_bt."""
    data, jg, pg = problem
    init = jnp.asarray(data.vio, jnp.float32)
    return (jdense.lm_solve_bt(jg, init, max_iterations=ITERS,
                               exact_linear=True),
            jwin.lm_solve_bt_sharded(jg, init, jax_mesh(4),
                                     max_iterations=ITERS),
            tdense.lm_solve_bt(pg, data.vio, device="cpu",
                               max_iterations=ITERS, exact_linear=True))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lm_matches_bt(runs, references, world):
    calls = runs["solve"][world]
    res = calls[0]["result"]
    for c in calls[1:]:                  # replicated scalars, whole poses
        assert float(c["result"].cost) == float(res.cost)
        np.testing.assert_array_equal(c["result"].poses, res.poses)
    cost = float(res.cost)
    assert np.isfinite(cost) and cost < float(res.initial_cost)
    for ref in references:
        assert abs(cost - float(ref.cost)) / float(ref.cost) < 5e-3
        assert np.max(np.abs(res.poses - np.asarray(ref.poses))) < 0.05
    assert calls[0]["kernels"]["k1"] == 0


def test_sharded_lm_padding_path(problem, runs):
    data, _, pg = problem
    res = runs["padded"][0]["result"]
    assert res.poses.shape == (F_CUT, 4, 4)
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < float(res.initial_cost)
    port = tdense.lm_solve_bt(cut_frames(pg, F_CUT), data.vio[:F_CUT],
                              device="cpu", max_iterations=20,
                              exact_linear=True)
    assert abs(float(res.cost) - float(port.cost)) / float(port.cost) < 5e-3
