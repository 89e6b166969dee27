"""Port vs reference: the block-tridiagonal linear paths.

The exact Cholesky ``bt_solve`` and the Newton-Schulz helpers
(tests/test_block_tridiag.py's shapes and bars), one exact-Woodbury and one
PCG linear step, the sparse loop form (tests/test_bt_lm.py:102-133), the
lock-step batched LM (:69-84), the pose covariances
(tests/test_covariance.py:24-47) and a damped system that is not positive
definite. Problems: D=4, F=20, seed 31 and D=3, F=12, seed 121, as the
reference's tests use them.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.eval import metrics as tmetrics
from omniswarm_torch.solver import block_tridiag as tbt
from omniswarm_torch.solver import dense as tdense
from omniswarm_torch.solver import gauss_newton as tgn
from omniswarm_tpu import sim
from omniswarm_tpu.solver import block_tridiag as jbt
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)


def random_spd_tridiag(rng, F, m, K=2):
    A = np.zeros((F, m, m))
    B = rng.normal(size=(F - 1, m, m)) * 0.3
    for f in range(F):
        M = rng.normal(size=(m, m))
        A[f] = M @ M.T + (m + 4) * np.eye(m)
    rhs = rng.normal(size=(F, m, K))
    return A.astype(np.float32), B.astype(np.float32), rhs.astype(np.float32)


def dense_of(A, B):
    F, m, _ = A.shape
    H = np.zeros((F * m, F * m))
    for f in range(F):
        H[f * m:(f + 1) * m, f * m:(f + 1) * m] = A[f]
    for f in range(F - 1):
        H[f * m:(f + 1) * m, (f + 1) * m:(f + 2) * m] = B[f]
        H[(f + 1) * m:(f + 2) * m, f * m:(f + 1) * m] = B[f].T
    return H


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("F,m,K,tol", [(1, 8, 3, 2e-3), (2, 8, 3, 2e-3),
                                       (3, 8, 3, 2e-3), (5, 8, 3, 2e-3),
                                       (8, 8, 3, 2e-3), (13, 8, 3, 2e-3),
                                       (100, 8, 3, 2e-3), (100, 20, 5, 5e-3)])
def test_bt_solve_matches_dense_and_jax(F, m, K, tol):
    A, B, rhs = random_spd_tridiag(np.random.default_rng(F + m), F, m, K)
    got = tbt.bt_solve(*_t(A, B, rhs)).numpy()
    want = np.linalg.solve(dense_of(A, B), rhs.reshape(F * m, K))
    np.testing.assert_allclose(got, want.reshape(F, m, K), rtol=tol, atol=tol)
    ref = np.asarray(jax.jit(jbt.bt_solve)(A, B, rhs))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_bt_solve_packed_repartition_exact():
    rng = np.random.default_rng(0)
    F, m, K = 11, 4, 3
    A = np.zeros((F, m, m), np.float32)
    for f in range(F):
        X = rng.normal(size=(m, m)).astype(np.float32)
        A[f] = X @ X.T + 4.0 * np.eye(m)
    B = 0.3 * rng.normal(size=(F - 1, m, m)).astype(np.float32)
    rhs = rng.normal(size=(F, m, K)).astype(np.float32)
    tA, tB, trhs = _t(A, B, rhs)
    x_ref = tbt.bt_solve(tA, tB, trhs).numpy()
    for p in (2, 4):
        Ap, Bp, F_true = tbt.pack_bt_mats(tA, tB, p)
        assert F_true == F
        xp = tbt.bt_solve(Ap, Bp, tbt.pack_bt_cols(trhs, p))
        np.testing.assert_allclose(tbt.unpack_bt_cols(xp, p, F).numpy(),
                                   x_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", [5, 12])
def test_bt_solve_block_not_pd_gives_nan_without_raising(bad):
    """Block 5 is odd (a level's block solve), block 12 even (it reaches
    the dense tail)."""
    A, B, rhs = random_spd_tridiag(np.random.default_rng(3), 20, 8, 2)
    A[bad] = -A[bad]
    assert bool(torch.isnan(tbt.bt_solve(*_t(A, B, rhs))).any())


def test_newton_schulz_helpers_match_jax():
    rng = np.random.default_rng(4)
    A, B, rhs = random_spd_tridiag(rng, 24, 8, 3)
    tA, tB, trhs = _t(A, B, rhs)
    S = A[0] @ A[0].T + np.eye(8, dtype=np.float32)
    b = rhs[0, :, 0]

    @jax.jit
    def oracle(A, B, rhs, S, b):
        return (jbt.ns_inverse(A, 6, bf16_head=4),
                jbt.bt_solve_ns(A, B, rhs, refine=2),
                jbt.spd_solve_approx(S, b))

    with jax.default_matmul_precision("highest"):
        want, want_ns, want_z = map(np.asarray, oracle(A, B, rhs, S, b))
    got = tbt.ns_inverse(tA, 6, bf16_head=4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    inv = np.linalg.inv(A)
    assert np.abs(got - inv).max() <= 1e-3 * np.abs(inv).max()
    got_ns = tbt.bt_solve_ns(tA, tB, trhs, refine=2).numpy()
    np.testing.assert_allclose(got_ns, want_ns, rtol=1e-4, atol=1e-4)
    x = np.linalg.solve(dense_of(A, B), rhs.reshape(-1, 3)).reshape(rhs.shape)
    np.testing.assert_allclose(got_ns, x, rtol=2e-3, atol=2e-3)
    got_z = tbt.spd_solve_approx(*_t(S, b)).numpy()
    np.testing.assert_allclose(got_z, want_z, rtol=1e-3,
                               atol=1e-4 * np.abs(want_z).max())
    z = np.linalg.solve(S, b)
    assert np.abs(got_z - z).max() <= 1e-3 * np.abs(z).max()


@pytest.fixture(scope="module")
def problem():
    data = sim.generate(sim.SimParams(num_drones=4, num_frames=20, seed=31))
    return data, jdense.dense_graph_from_sim(data)


def _blocks(graph, poses, loops_dense=True):
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jdense.assemble_blocks, static_argnames="loops_dense")(
            graph, jnp.asarray(poses), loops_dense=loops_dense)
    got = tdense.assemble_blocks(dense_graph_to_torch(graph, "cpu"),
                                 torch.from_numpy(poses),
                                 loops_dense=loops_dense)
    return want, got


def test_sparse_loops_match_jax_and_dense_U(problem):
    """assemble_blocks(loops_dense=False) against the reference's, and its
    loop term against U U^T (the reference test's bars)."""
    data, graph = problem
    poses = np.asarray(data.vio, np.float32)
    (jA, jB, jg, jsl, jc), (A, B, g, sl, c) = _blocks(graph, poses, False)
    _, (A1, B1, g1, U, c1) = _blocks(graph, poses, True)
    assert isinstance(sl, tdense.SparseLoops)
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-5)
    np.testing.assert_allclose(float(c), float(c1), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g1.numpy(), atol=1e-5)
    for name, got, want in zip(tdense.SparseLoops._fields, sl, jsl):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1),
                                   err_msg=name)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jg)).max())
    F, m = A.shape[:2]
    v = np.random.default_rng(5).normal(size=(F, m)).astype(np.float32)
    Ud = U.numpy()
    want = np.einsum("fmc,c->fm", Ud, np.einsum("fmc,fm->c", Ud, v))
    jab, rows2 = tdense._endpoint_blocks(sl)
    got = tdense.loop_matvec(jab, rows2, torch.from_numpy(v).reshape(-1))
    np.testing.assert_allclose(got.numpy().reshape(F, m), want, atol=2e-3)
    np.testing.assert_allclose(sl.diag.numpy(),
                               np.einsum("fmc,fmc->fm", Ud, Ud), atol=2e-3)


@pytest.mark.parametrize("pack,fused", [(1, False), (2, True)])
def test_pcg_steps_match_jax(problem, pack, fused):
    """A cold and a warm 24-sweep CG step (the seed's warm state fed on),
    as lm_solve_bt takes them; pack 2 fused runs the port's K1 dispatch."""
    data, graph = problem
    poses = np.asarray(data.vio, np.float32)
    (jA, jB, jg, jsl, _), (A, B, g, sl, _) = _blocks(graph, poses, False)
    lam = 1e-3

    @jax.jit
    def two_steps(A, B, g, sl):
        dx0, warm = jdense._pcg_solve_core(A, B, g, sl, lam, pack=pack)
        dx1, _ = jdense._pcg_solve_core(A, B, g, sl, lam * 0.3, warm,
                                        pack=pack)
        return dx0, dx1

    with jax.default_matmul_precision("highest"):
        want = two_steps(jA, jB, jg, jsl)
    t0, warm = tdense._pcg_solve_core(A, B, g, sl, torch.tensor(lam),
                                      pack=pack)
    assert len(warm) == 3 and warm[2].shape == g.shape
    t1, _ = tdense._pcg_solve_core(A, B, g, sl, torch.tensor(lam * 0.3),
                                   warm, pack=pack, fused_levels=fused)
    for w, got in zip(want, (t0, t1)):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-3 * np.abs(w).max()


def test_exact_smw_step_matches_jax_and_dense(problem):
    data, graph = problem
    poses = np.asarray(data.vio, np.float32)
    (jA, jB, jg, jU, _), (A, B, g, U, _) = _blocks(graph, poses, True)
    lam = 1e-3
    with jax.default_matmul_precision("highest"):
        want, wwarm = jax.jit(lambda *a: jdense._smw_solve_core(
            *a, lam, exact=True))(jA, jB, jg, jU)
    got, warm = tdense._smw_solve_core(A, B, g, U, torch.tensor(lam),
                                       exact=True)
    assert warm == () and wwarm == ()
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # against the damped dense system T + U U^T
    F, m = A.shape[:2]
    H = dense_of(A.numpy(), B.numpy()) + U.numpy().reshape(F * m, -1) @ \
        U.numpy().reshape(F * m, -1).T
    H = H + np.diag(lam * np.maximum(np.diag(H), 1e-6))
    x = np.linalg.solve(H, -g.numpy().reshape(-1))
    assert np.abs(got.numpy() - x).max() <= 2e-3 * np.abs(x).max()


def test_indefinite_damped_system_is_rejected_without_raising():
    """A damped H that is not positive definite: the Cholesky step and the
    exact Woodbury step come back bad, LM rejects, λ grows, no raise."""
    rng = np.random.default_rng(7)
    M = rng.normal(size=(8, 8))
    H = torch.from_numpy((M + M.T - 20 * np.eye(8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    dx, bad = tgn.damped_cholesky_step(H, g, torch.tensor(1e-4))
    assert bool(bad) and not bool(dx.abs().any())
    poses0 = torch.zeros((2, 1, 4))
    costs = iter([5.0, 4.0])

    def assemble(poses):
        return H, g, torch.tensor(next(costs, 3.0))

    res = tgn.run_lm_loop(assemble, poses0, max_iterations=3)
    assert res.iterations == 3
    assert torch.equal(res.poses, poses0)
    assert float(res.cost) == 5.0
    np.testing.assert_allclose(float(res.lam), 1e-4 * 5 ** 3, rtol=1e-6)

    A, B, rhs = random_spd_tridiag(rng, 8, 4, 1)
    A[3] = -A[3]
    U = torch.from_numpy(rng.normal(size=(8, 4, 8)).astype(np.float32) * .1)
    dx, warm = tdense._smw_solve_core(*_t(A, B), torch.from_numpy(
        rhs[..., 0]), U, torch.tensor(1e-4), exact=True)
    assert warm == () and not bool(torch.isfinite(dx).all())


def test_lm_solve_bt_batched_matches_single_and_jax(problem):
    data, graph = problem
    rng = np.random.default_rng(0)
    inits = np.tile(np.asarray(data.vio, np.float32)[None], (3, 1, 1, 1))
    inits[1, :, 1:, :3] += rng.normal(0, 0.3, size=(20, 3, 3))
    inits[2, :, 1:, :3] += rng.normal(0, 0.6, size=(20, 3, 3))
    rb = tdense.lm_solve_bt_batched(graph, inits, device="cpu",
                                    max_iterations=40)
    ref = jdense.lm_solve_bt_batched(graph, jnp.asarray(inits),
                                     max_iterations=40)
    assert rb.iterations == int(ref.iterations)
    np.testing.assert_allclose(rb.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    for b in range(3):
        rs = tdense.lm_solve_bt(graph, inits[b], device="cpu",
                                max_iterations=40)
        np.testing.assert_allclose(float(rb.cost[b]), float(rs.cost),
                                   rtol=0.05, atol=0.5)
    rel = tmetrics.mean_relative_ate(rb.poses[0].numpy(), data.gt)
    assert rel < 0.08, rel
    # the same problem stacked per lane gives the same lanes
    stacked = jtu.tree_map(lambda *x: np.stack(x), *[graph] * 3)
    rs = tdense.lm_solve_bt_batched(stacked, inits, device="cpu",
                                    max_iterations=40)
    assert torch.equal(rs.cost, rb.cost) and torch.equal(rs.poses, rb.poses)


@pytest.fixture(scope="module")
def solved():
    data = sim.generate(sim.SimParams(num_drones=3, num_frames=12, seed=121))
    graph = jdense.dense_graph_from_sim(data)
    res = jdense.lm_solve_bt(graph, jnp.asarray(data.vio, jnp.float32),
                             max_iterations=50)
    return data, graph, np.asarray(res.poses)


def test_pose_covariances_match_dense_inverse_and_jax(solved):
    data, graph, poses = solved
    D = graph.pose_valid.shape[1]
    query = np.asarray([[5, 1], [11, 2], [0, 1], [0, 0]], np.int32)
    cov = tdense.pose_covariances(graph, poses, query, device="cpu").numpy()
    want = np.asarray(jdense.pose_covariances_jit(graph, jnp.asarray(poses),
                                                  jnp.asarray(query)))
    np.testing.assert_allclose(cov, want, rtol=0.05, atol=5e-4)
    H, _, _ = jax.jit(jdense.assemble_dense)(graph, jnp.asarray(poses))
    Hinv = np.linalg.inv(np.asarray(H) + 1e-6 * np.eye(H.shape[0]))
    for q, (f, d) in enumerate(query[:3]):
        i = 4 * (f * D + d)
        np.testing.assert_allclose(cov[q], Hinv[i:i + 4, i:i + 4],
                                   rtol=0.05, atol=5e-4)
    assert not cov[3].any()               # the gauge-fixed pose


def test_pose_covariance_properties(solved):
    data, graph, poses = solved
    cov = tdense.pose_covariances(graph, poses, [[3, 0], [3, 1]],
                                  device="cpu").numpy()
    for c in cov:
        np.testing.assert_allclose(c, c.T, atol=1e-5)
        assert (np.linalg.eigvalsh(c) > -1e-6).all()
        assert np.sqrt(np.abs(np.diag(c)[:3])).max() < 1.0
