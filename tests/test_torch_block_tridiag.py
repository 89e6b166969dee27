"""Port vs reference: block-tridiagonal packing, Newton-Schulz inverses and
the cyclic-reduction factor/apply (f32 and bf16 right-hand sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.solver import block_tridiag as tbt
from omniswarm_tpu.solver import block_tridiag as jbt

torch.set_num_threads(1)


def _spd_tridiag(rng, F, m, K=3):
    A = np.zeros((F, m, m))
    B = rng.normal(size=(F - 1, m, m)) * 0.3
    for f in range(F):
        M = rng.normal(size=(m, m))
        A[f] = M @ M.T + (m + 4) * np.eye(m)   # strongly diag-dominant SPD
    rhs = rng.normal(size=(F, m, K))
    return A.astype(np.float32), B.astype(np.float32), rhs.astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("p", [1, 2, 3])
def test_pack_roundtrip_matches_jax(p):
    rng = np.random.default_rng(p)
    A, B, rhs = _spd_tridiag(rng, 11, 4)
    jA, jB, jF = jbt.pack_bt_mats(jnp.asarray(A), jnp.asarray(B), p)
    tA, tB, tF = tbt.pack_bt_mats(*_t(A, B), p)
    assert jF == tF == 11
    np.testing.assert_array_equal(tA.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    jx = jbt.pack_bt_cols(jnp.asarray(rhs), p)
    tx = tbt.pack_bt_cols(*_t(rhs), p)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tbt.unpack_bt_cols(tx, p, 11).numpy(), rhs)


def test_ns_inverse_matches_jax():
    rng = np.random.default_rng(1)
    A, _, _ = _spd_tridiag(rng, 6, 16)
    want = np.asarray(jbt.ns_inverse(jnp.asarray(A), 12))
    got = tbt.ns_inverse(*_t(A), 12).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(
        want).max())


@pytest.mark.parametrize("warm", ["close", "garbage"])
def test_ns_inverse_warm_matches_jax(warm):
    rng = np.random.default_rng(2)
    A, _, _ = _spd_tridiag(rng, 6, 16)
    if warm == "close":
        X0 = (np.linalg.inv(A.astype(np.float64)) * 1.01).astype(np.float32)
    else:
        X0 = np.full_like(A, 50.0)
    want = np.asarray(jbt.ns_inverse_warm(jnp.asarray(A), jnp.asarray(X0)))
    got = tbt.ns_inverse_warm(*_t(A, X0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(
        want).max())


def _factor(mod, A, B, pack, warm_scale, **kw):
    """Cold factor of (A, B), then (if warm_scale) a warm factor of the
    perturbed matrix seeded by it."""
    Ap, Bp, _ = mod.pack_bt_mats(A, B, pack)
    fac = mod.bt_factor(Ap, Bp, direct_threshold=4, ns_iters=12)
    if warm_scale:
        A2, B2, _ = mod.pack_bt_mats(A * warm_scale, B, pack)
        fac = mod.bt_factor(A2, B2, direct_threshold=4,
                            warm=mod.bt_warm_state(fac), **kw)
    return fac


def _apply_both(A, B, rhs, pack, warm_scale, dtype):
    """bt_apply of the packed rhs (cast to dtype) on both sides; the JAX
    side runs as one jitted program."""
    @jax.jit
    def ref(A, B, rhs):
        fac = _factor(jbt, A, B, pack, warm_scale)
        out = jbt.bt_apply(fac, jbt.pack_bt_cols(rhs, pack).astype(dtype))
        return out.astype(jnp.float32)

    want = np.asarray(ref(*map(jnp.asarray, (A, B, rhs))))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tfac = _factor(tbt, *_t(A, B), pack, warm_scale, fused=pack > 1)
    tr = tbt.pack_bt_cols(torch.from_numpy(rhs), pack)
    got = tbt.bt_apply(tfac, tr.to(tdt))
    assert got.dtype == tdt
    return want, got.float().numpy(), tfac, tr


@pytest.mark.parametrize("pack,warm", [(1, False), (1, True), (2, False),
                                       (2, True)])
def test_bt_factor_apply_f32_matches_jax(pack, warm):
    rng = np.random.default_rng(10 + pack)
    A, B, rhs = _spd_tridiag(rng, 23, 8)
    want, got, tfac, tr = _apply_both(A, B, rhs, pack,
                                      1.01 if warm else 0.0, jnp.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # the solve itself is right: T x ~= rhs after one refinement pass
    Ap, Bp, _ = tbt.pack_bt_mats(*_t(A * (1.01 if warm else 1.0), B), pack)
    x = tbt.bt_apply(tfac, tr)
    x = x + tbt.bt_apply(tfac, tr - tbt.bt_matvec(Ap, Bp, x))
    res = (tbt.bt_matvec(Ap, Bp, x) - tr).abs().max().item()
    assert res < 1e-3 * tr.abs().max().item(), res


def test_bt_apply_bf16_rhs_matches_jax():
    rng = np.random.default_rng(20)
    A, B, rhs = _spd_tridiag(rng, 23, 8, K=12)
    want, got, _, _ = _apply_both(A, B, rhs, 2, 1.01, jnp.bfloat16)
    diff = np.abs(got - want).max()
    assert diff <= 1e-2 * np.abs(want).max(), diff


def test_bt_matvec_matches_jax():
    rng = np.random.default_rng(21)
    A, B, rhs = _spd_tridiag(rng, 9, 8)
    want = np.asarray(jbt.bt_matvec(*map(jnp.asarray, (A, B, rhs))))
    got = tbt.bt_matvec(*_t(A, B, rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
