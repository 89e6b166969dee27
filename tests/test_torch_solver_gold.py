"""Port vs reference: the gold paths (generic factor graph and dense H).

Residuals and their autodiff Jacobians (tests/test_factors.py's inputs and
bars), GraphBuilder / build_graph_from_sim / dense_from_factor_graph,
assemble_normal_equations against assemble_dense
(tests/test_dense_solver.py's problem, D=4, F=20, seed 31, and its bars),
the dense and generic LM solves, and tests/test_solver.py's small graphs
(chain, two-drone ranges, an outlier loop, multi-init, fixed and invalid
poses).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch import sim as tsim
from omniswarm_torch.convert import (dense_graph_to_torch,
                                     factor_graph_to_torch)
from omniswarm_torch.eval import metrics as tmetrics
from omniswarm_torch.sim.pipeline import build_graph_from_sim
from omniswarm_torch.solver import dense as tdense
from omniswarm_torch.solver import factors as tfx
from omniswarm_torch.solver import gauss_newton as tgn
from omniswarm_torch.solver import graph as tgraph
from omniswarm_tpu import sim
from omniswarm_tpu.core import geometry as jgeo
from omniswarm_tpu.solver import dense as jdense
from omniswarm_tpu.solver import factors as jfx
from omniswarm_tpu.solver import gauss_newton as jgn

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_solver as jsolver  # noqa: E402  (the reference's canned graphs)

torch.set_num_threads(1)


def rand_pose(rng):
    return np.concatenate([rng.normal(size=3) * 5,
                           rng.uniform(-3, 3, size=1)])


def _factor_inputs(rng, n=10):
    """test_factors.py's random inputs, n at a time, f32."""
    pa = np.stack([rand_pose(rng) for _ in range(n)])
    pb = np.stack([rand_pose(rng) for _ in range(n)])
    meas = np.stack([rand_pose(rng) for _ in range(n)])
    si = np.stack([np.diag(rng.uniform(0.5, 10, size=4)) for _ in range(n)])
    dpa = np.stack([rand_pose(rng) * 0.05 for _ in range(n)])
    dpb = np.stack([rand_pose(rng) * 0.05 for _ in range(n)])
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tb = np.asarray(jgeo.tangent_base_from_unit(jnp.asarray(dirs,
                                                            jnp.float32)))
    invd = rng.uniform(0.05, 0.5, size=n)
    depth = rng.uniform(size=n) > 0.3
    ant = rng.normal(size=(2, n, 3)) * 0.2
    return [np.asarray(v, np.float32) if v.dtype != bool else v
            for v in (pa, pb, meas, si, dpa, dpb, dirs, tb, invd, depth,
                      ant[0], ant[1])]


def _evals(mod, arr, conv):
    n = arr[0].shape[0]
    pa, pb, meas, si, dpa, dpb, dirs, tb, invd, depth, ant_a, ant_b, d, s = \
        map(conv, arr + [np.full(n, 3.0, np.float32),
                         np.full(n, 7.07, np.float32)])
    return {
        "range": mod.range_eval(pa, pb, d, s),
        "range_antenna": mod.range_eval_antenna(pa, pb, d, s, ant_a, ant_b),
        "relpose": mod.relpose_eval(pa, pb, meas, si),
        "detection": mod.make_detection_eval(0.1, 0.5)(
            pa, pb, dirs, tb, invd, dpa, dpb, depth),
    }


@pytest.mark.parametrize("family", ["range", "range_antenna", "relpose",
                                    "detection"])
def test_factor_evals_match_jax(family):
    arr = _factor_inputs(np.random.default_rng(0))
    want = _evals(jfx, arr, jnp.asarray)[family]
    got = _evals(tfx, arr, torch.tensor)[family]
    assert isinstance(got, tfx.FactorEval)
    for name, g, w in zip(tfx.FactorEval._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1),
                                   err_msg=f"{family} {name}")


def test_detection_depth_mask_survives_jacfwd():
    rng = np.random.default_rng(1)
    pa, pb = rand_pose(rng), rand_pose(rng)
    zero = np.zeros((1, 4), np.float32)
    args = [torch.from_numpy(np.asarray(v, np.float32)) for v in (
        pa[None], pb[None], [[1.0, 0, 0]], [[[0, 1, 0], [0, 0, 1.0]]], [0.5],
        zero, zero)]
    det = tfx.make_detection_eval(0.1, 0.5)
    with_depth = det(*args, torch.tensor([True]))
    without = det(*args, torch.tensor([False]))
    assert abs(float(without.residual[0, 2])) < 1e-8
    assert not bool(without.jac_a[0, 2].any() or without.jac_b[0, 2].any())
    assert bool(with_depth.jac_b[0, 2].any())
    np.testing.assert_allclose(with_depth.residual[0, :2].numpy(),
                               without.residual[0, :2].numpy(), atol=1e-7)


def test_huber_weight_and_rho():
    r = torch.tensor([[0.3, 0.4], [3.0, 4.0]])
    np.testing.assert_allclose(tfx.huber_weight(r, 1.0).numpy(), [1.0, 0.2])
    np.testing.assert_allclose(
        tfx.huber_rho(torch.tensor([0.25, 25.0]), 1.0).numpy(), [0.25, 9.0])


@pytest.fixture(scope="module")
def problem():
    params = sim.SimParams(num_drones=4, num_frames=20, seed=31)
    data = sim.generate(params)
    jsparse, init = sim.build_graph_from_sim(data, enable_detections=True)
    tdata = tsim.generate(tsim.SimParams(num_drones=4, num_frames=20,
                                         seed=31))
    tsparse, tinit = build_graph_from_sim(tdata, enable_detections=True)
    return data, jsparse, tsparse, jdense.dense_graph_from_sim(data), tinit


def _leaves(x):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(x)]


def test_build_graph_from_sim_matches_jax(problem):
    data, jsparse, tsparse, _, tinit = problem
    np.testing.assert_array_equal(tinit, np.asarray(data.vio, np.float32))
    assert type(tsparse) is tgraph.FactorGraph
    for name in tgraph.FactorGraph._fields:
        want, got = getattr(jsparse, name), getattr(tsparse, name)
        for w, g in zip(_leaves(want), _leaves(got)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    conv = factor_graph_to_torch(jsparse, "cpu")
    assert conv.dets.direction.dtype == torch.float32
    assert conv.loops.frame_a.dtype == torch.int64


def test_dense_from_factor_graph_matches_jax(problem):
    data, jsparse, tsparse, jg, _ = problem
    want = jdense.dense_from_factor_graph(jsparse)
    got = tdense.dense_from_factor_graph(tsparse)
    assert got is not None
    for name in tdense.DenseGraph._fields:
        for w, g in zip(_leaves(getattr(want, name)),
                        _leaves(getattr(got, name))):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    # an odometry factor that skips a frame breaks the chain structure
    fb = np.array(tsparse.odoms.frame_b)
    fb[0] += 1
    broken = tsparse._replace(odoms=tsparse.odoms._replace(frame_b=fb))
    assert tdense.dense_from_factor_graph(broken) is None


@pytest.mark.parametrize("at", ["vio", "perturbed"])
def test_normal_equations_match_jax_and_dense(problem, at):
    """assemble_normal_equations and assemble_dense against the reference's
    and against each other (tests/test_dense_solver.py's bars)."""
    data, jsparse, tsparse, jg, tinit = problem
    poses = tinit
    if at == "perturbed":
        poses = poses + np.random.default_rng(0).normal(
            0, 0.2, size=poses.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        Hs, gs, cs = jax.jit(jgn.assemble_normal_equations)(jsparse, poses)
        Hd, gd, cd = jax.jit(jdense.assemble_dense)(jg, poses)
    tp = torch.from_numpy(poses)
    tH, tg, tc = tgn.assemble_normal_equations(
        factor_graph_to_torch(tsparse, "cpu"), tp)
    dH, dg, dc = tdense.assemble_dense(dense_graph_to_torch(jg, "cpu"), tp)
    for H, g, c, (rH, rg, rc) in ((tH, tg, tc, (Hs, gs, cs)),
                                  (dH, dg, dc, (Hd, gd, cd))):
        np.testing.assert_allclose(float(c), float(rc), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(rg)).max())
        np.testing.assert_allclose(H.numpy(), np.asarray(rH), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(rH)).max())
    np.testing.assert_allclose(float(dc), float(tc), rtol=1e-4)
    np.testing.assert_allclose(dg.numpy(), tg.numpy(), rtol=2e-3, atol=5e-2)
    np.testing.assert_allclose(dH.numpy(), tH.numpy(), rtol=2e-3, atol=5e-2)
    np.testing.assert_allclose(
        float(tgn.total_cost(factor_graph_to_torch(tsparse, "cpu"), tp)),
        float(tc), rtol=1e-6)


def test_assemble_dense_antenna_matches_jax(problem):
    data = problem[0]
    ant = np.random.default_rng(5).normal(size=(4, 3)) * 0.15
    jg = jdense.dense_graph_from_sim(data, ant_pos=ant)
    poses = np.asarray(data.vio, np.float32)
    with jax.default_matmul_precision("highest"):
        rH, rg, rc = jax.jit(jdense.assemble_dense)(jg, poses)
    H, g, c = tdense.assemble_dense(dense_graph_to_torch(jg, "cpu"),
                                    torch.from_numpy(poses))
    np.testing.assert_allclose(float(c), float(rc), rtol=1e-5)
    for got, want in ((H, rH), (g, rg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_dense_and_generic_solves_match_jax(problem):
    """lm_solve_dense and lm_solve against the reference's, and against each
    other at tests/test_dense_solver.py's bars (cost 5e-2, relative-ATE
    difference 0.03, relative ATE < 0.08)."""
    data, jsparse, tsparse, jg, tinit = problem
    init = jnp.asarray(tinit)
    rd = tdense.lm_solve_dense(jg, tinit, device="cpu", max_iterations=40)
    rs = tgn.lm_solve(tsparse, tinit, device="cpu", max_iterations=40)
    for got, ref in ((rd, jdense.lm_solve_dense(jg, init, max_iterations=40)),
                     (rs, jgn.lm_solve(jsparse, init, max_iterations=40))):
        np.testing.assert_allclose(float(got.initial_cost),
                                   float(ref.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(float(got.cost), float(ref.cost),
                                   rtol=1e-3)
        assert tmetrics.mean_relative_ate(got.poses.numpy(),
                                          np.asarray(ref.poses)) < 5e-3
    np.testing.assert_allclose(float(rd.cost), float(rs.cost), rtol=5e-2)
    rel_d = tmetrics.mean_relative_ate(rd.poses.numpy(), data.gt)
    rel_s = tmetrics.mean_relative_ate(rs.poses.numpy(), data.gt)
    assert rel_d < 0.08 and abs(rel_s - rel_d) < 0.03, (rel_s, rel_d)


def test_dense_batched_matches_jax(problem):
    data, _, _, jg, tinit = problem
    rng = np.random.default_rng(0)
    inits = np.tile(tinit[None], (3, 1, 1, 1))
    inits[1, :, 1:, :3] += rng.normal(0, 0.3, size=(20, 3, 3))
    inits[2, :, 1:, :3] += rng.normal(0, 0.6, size=(20, 3, 3))
    ref = jdense.lm_solve_dense_batched(jg, jnp.asarray(inits),
                                        max_iterations=40)
    got = tdense.lm_solve_dense_batched(jg, inits, device="cpu",
                                        max_iterations=40)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    for b in range(3):
        assert tmetrics.mean_relative_ate(got.poses[b].numpy(),
                                          np.asarray(ref.poses[b])) < 5e-3


def _graphs(build, **kw):
    """A canned graph of tests/test_solver.py built twice: by the
    reference's GraphBuilder and by the port's (numpy leaves)."""
    graph, gt = build(**kw)
    saved = jsolver.GraphBuilder
    jsolver.GraphBuilder = tgraph.GraphBuilder
    try:
        port_graph, _ = build(**kw)
    finally:
        jsolver.GraphBuilder = saved
    assert type(port_graph) is tgraph.FactorGraph
    for w, g in zip(_leaves(graph), _leaves(port_graph)):
        np.testing.assert_array_equal(g, w)
    return graph, port_graph, gt


def _both_solves(graphs, init, **kw):
    ref = jgn.lm_solve(graphs[0], jnp.asarray(init, jnp.float32), **kw)
    got = tgn.lm_solve(graphs[1], init, device="cpu", **kw)
    return ref, got


def test_single_drone_chain_exact():
    *graphs, gt = _graphs(jsolver.build_single_drone_chain, F=10)
    init = np.tile(gt[0], (10, 1, 1)).astype(np.float32)
    ref, res = _both_solves(graphs, init, max_iterations=50)
    est = res.poses[:, 0, :].numpy()
    assert float(res.cost) < 1e-3, float(res.cost)
    np.testing.assert_allclose(est[:, :3], gt[:, :3], atol=1e-2)
    np.testing.assert_allclose(np.cos(est[:, 3]), np.cos(gt[:, 3]), atol=1e-3)
    np.testing.assert_allclose(est, np.asarray(ref.poses)[:, 0], atol=1e-3)
    assert float(tgn.total_cost(factor_graph_to_torch(graphs[1], "cpu"),
                                torch.tensor(gt[:, None, :],
                                             dtype=torch.float32))) < 1e-6


@pytest.mark.parametrize("outlier", [False, True])
def test_two_drone_range_fusion(outlier):
    rng = np.random.default_rng(0)
    *graphs, gt = _graphs(jsolver.build_two_drone_ranges, F=12,
                          outlier_loop=outlier)
    init = np.array(gt, np.float32)
    init[:, 1, :3] += rng.normal(size=(12, 3)) * (0.3 if outlier else 0.5)
    if not outlier:
        init[:, 1, 3] += rng.normal(size=12) * 0.2
    ref, res = _both_solves(graphs, init, max_iterations=80)
    est = res.poses.numpy()
    err = np.linalg.norm(est[:, 1, :3] - gt[:, 1, :3], axis=1)
    np.testing.assert_allclose(est, np.asarray(ref.poses), atol=1e-3)
    if not outlier:
        assert err.max() < 0.05, err.max()
        return
    _, res_nr = _both_solves(graphs, init, max_iterations=80,
                             huber_delta=1e6)
    err_nr = np.linalg.norm(res_nr.poses[:, 1, :3].numpy() - gt[:, 1, :3],
                            axis=1)
    assert err.max() < 0.3 and err.max() < 0.5 * err_nr.max()


def test_multi_init_recovers_from_bad_starts():
    rng = np.random.default_rng(0)
    graph, port_graph, gt = _graphs(jsolver.build_two_drone_ranges, F=12)
    B = 4
    inits = np.tile(np.asarray(gt, np.float32), (B, 1, 1, 1))
    for k in range(B - 1):
        inits[k, :, 1, :3] = rng.normal(size=(12, 3)) * 4.0
        inits[k, :, 1, 3] = rng.uniform(-3, 3, size=12)
    inits[B - 1, :, 1, :3] += rng.normal(size=(12, 3)) * 0.2
    ref = jgn.lm_solve_multi_init(graph, jnp.asarray(inits),
                                  max_iterations=80)
    lanes = []

    def recording(*a, **k):
        lanes.append(run(*a, **k))
        return lanes[-1]

    run = tgn.run_lm_loop
    tgn.run_lm_loop = recording
    try:
        res = tgn.lm_solve_multi_init(port_graph, inits, device="cpu",
                                      max_iterations=80)
    finally:
        tgn.run_lm_loop = run
    est = res.poses.numpy()
    err = np.linalg.norm(est[:, 1, :3] - gt[:, 1, :3], axis=1)
    assert err.max() < 0.1, (err.max(), float(res.cost))
    np.testing.assert_allclose(est, np.asarray(ref.poses), atol=1e-3)
    # every lane ran its own loop to its own end; the least cost wins
    assert len(lanes) == B and len({r.iterations for r in lanes}) > 1
    assert res is min(lanes, key=lambda r: float(r.cost))


def test_fixed_and_invalid_poses():
    rng = np.random.default_rng(0)
    *graphs, gt = _graphs(jsolver.build_two_drone_ranges, F=6)
    init = np.asarray(gt, np.float32).copy()
    init[:, 1, :3] += rng.normal(size=(6, 3)) * 0.3
    _, res = _both_solves(graphs, init, max_iterations=30)
    np.testing.assert_allclose(res.poses[:, 0, :].numpy(), gt[:, 0, :],
                               atol=1e-6)
    cgt = np.stack([jsolver.circle_pose(i * 0.5) for i in range(10)])
    b = tgraph.GraphBuilder(10, 2, max_ranges=16, max_odoms=64,
                            max_loops=16, max_dets=16)
    for i in range(10):
        b.set_pose_valid(i, 0, fixed=(i == 0))
    for i in range(9):
        b.add_odom(0, i, i + 1, jsolver.np_delta(cgt[i], cgt[i + 1]),
                   tgraph.diag_sqrt_info(0.05, 0.02))
    init = np.zeros((10, 2, 4), np.float32)
    init[:, 0] = cgt[0]
    init[:, 1] = (7.0, -7.0, 7.0, 0.5)    # drone 1 is never valid
    res = tgn.lm_solve(b.build(), init, device="cpu", max_iterations=50)
    assert bool(torch.isfinite(res.poses).all())
    assert torch.equal(res.poses[:, 1], torch.from_numpy(init[:, 1]))
    np.testing.assert_allclose(res.poses[:, 0, :3].numpy(), cgt[:, :3],
                               atol=1e-2)
