"""Port vs reference: block-form normal equations and one Woodbury solve on
the tests/test_bt_lm.py problem (D=4, F=20, seed 31)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.solver import dense as tdense
from omniswarm_tpu import sim
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
NAMES = ("A", "Boff", "g", "U")


@pytest.fixture(scope="module")
def problem():
    data = sim.generate(sim.SimParams(num_drones=4, num_frames=20, seed=31))
    ant = np.random.default_rng(5).normal(size=(4, 3)) * 0.15
    return data, ant


def _both(data, ant_pos, poses, jg=None):
    if jg is None:
        jg = jdense.dense_graph_from_sim(data, ant_pos=ant_pos)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jdense.assemble_blocks)(jg, jnp.asarray(poses))
    tg = dense_graph_to_torch(jg, "cpu")
    got = tdense.assemble_blocks(tg, torch.from_numpy(poses))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("ant", [False, True])
@pytest.mark.parametrize("at", ["vio", "perturbed"])
def test_assemble_blocks_matches_jax(problem, ant, at):
    data, ant_pos = problem
    poses = np.asarray(data.vio, np.float32)
    if at == "perturbed":
        poses = poses + np.random.default_rng(6).normal(
            0, 0.2, poses.shape).astype(np.float32)
    want, got = _both(data, ant_pos if ant else None, poses)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5)
    for name, g, w in zip(NAMES, got[:4], want[:4]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("at", ["vio", "perturbed"])
def test_assemble_blocks_shared_loop_rows_match_jax(problem, at):
    """Loops whose endpoints land on the same frame rows: the port sums
    their gradient rows as one product with the loop columns (U @ r), the
    reference scatter-adds them; both give the same g and U."""
    data, _ = problem
    jg = jdense.dense_graph_from_sim(data)
    lp = jg.loops
    fa, da, fb, db = (np.array(v) for v in (lp.frame_a, lp.drone_a,
                                            lp.frame_b, lp.drone_b))
    valid = np.flatnonzero(np.asarray(lp.valid))
    k0 = valid[0]
    row = (fa[k0], da[k0])
    off_b = [k for k in valid[1:] if (fb[k], db[k]) != row]
    off_a = [k for k in valid[1:] if (fa[k], da[k]) != row]
    k1, k2 = off_b[:2]
    k3 = next(k for k in off_a if k not in (k1, k2))
    fa[[k1, k2]], da[[k1, k2]] = row                # three loops start on
    fb[k3], db[k3] = row                            # one row, a fourth ends
    assert not ((fa == fb) & (da == db))[valid].any()   # there
    jg = jg._replace(loops=lp._replace(frame_a=fa, drone_a=da, frame_b=fb,
                                       drone_b=db))
    poses = np.asarray(data.vio, np.float32)
    if at == "perturbed":
        poses = poses + np.random.default_rng(8).normal(
            0, 0.2, poses.shape).astype(np.float32)
    want, got = _both(data, None, poses, jg)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5)
    for name, g, w in zip(NAMES, got[:4], want[:4]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_smw_solve_matches_jax(problem):
    """One cold and one warm damped Woodbury step, U carried in bf16."""
    data, _ = problem
    jg = jdense.dense_graph_from_sim(data)
    poses = np.asarray(data.vio, np.float32)
    A, B, g, U, _ = jax.jit(jdense.assemble_blocks)(jg, jnp.asarray(poses))
    U = U.astype(jnp.bfloat16)
    lam = jnp.asarray(1e-3, jnp.float32)

    @jax.jit
    def two_steps(A, B, g, U, lam):
        dx0, warm = jdense._smw_solve_core(A, B, g, U, lam, pack=2)
        dx1, _ = jdense._smw_solve_core(A, B, g, U, lam * 0.3, warm, pack=2)
        return dx0, dx1

    dx0, dx1 = two_steps(A, B, g, U, lam)
    tA, tB, tg = (torch.tensor(np.asarray(v)) for v in (A, B, g))
    tU = torch.tensor(np.asarray(U.astype(jnp.float32))).to(torch.bfloat16)
    tlam = torch.tensor(1e-3)
    t0, twarm = tdense._smw_solve_core(tA, tB, tg, tU, tlam, pack=2)
    t1, _ = tdense._smw_solve_core(tA, tB, tg, tU, tlam * 0.3, twarm,
                                   pack=2, fused_levels=True)
    for want, got in ((dx0, t0), (dx1, t1)):
        want = np.asarray(want)
        diff = np.abs(got.numpy() - want).max()
        assert diff <= 1e-2 * np.abs(want).max(), diff
