"""Port vs reference: the fused cyclic-reduction level.

The plain PyTorch version is held against the JAX Pallas kernel (interpret
mode on CPU) and the XLA level body at rtol = atol = 2e-4, as in
tests/test_pallas_level.py. The CUDA kernel is held against the plain
version on a card by tests/test_torch_kernels_card.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.solver import fused_level as tfl
from omniswarm_tpu.solver.block_tridiag import ns_inverse_warm
from omniswarm_tpu.solver.pallas_level import fused_reduction_level

torch.set_num_threads(1)

NAMES = ("Ainv", "B_left", "B_right", "W_l", "W_r", "A_new", "B_new")
TOL = dict(rtol=2e-4, atol=2e-4)


def _xla_level(A, B, X0):
    """The bt_factor level body (block_tridiag.py) in its XLA form."""
    Fl = A.shape[0]
    A_odd = A[1::2]
    B_left = B[0::2]
    B_right = jnp.zeros_like(B_left)
    if Fl > 2:
        B_right = B_right.at[:-1].set(B[1::2])
    Ainv = ns_inverse_warm(A_odd, X0, 2)
    W_l = jnp.einsum("tij,tjk->tik", B_left, Ainv)
    W_r = jnp.einsum("tji,tjk->tik", B_right, Ainv)
    A_new = A[0::2] - jnp.einsum("tij,tkj->tik", W_l, B_left)
    A_new = A_new.at[1:].add(
        -jnp.einsum("tij,tjk->tik", W_r, B_right)[:-1])
    B_new = -jnp.einsum("tij,tjk->tik", W_l, B_right)[:-1]
    return Ainv, B_left, B_right, W_l, W_r, A_new, B_new


def _random_level(rng, Fl, m, warm="warm"):
    A = np.zeros((Fl, m, m), np.float32)
    for f in range(Fl):
        X = rng.normal(size=(m, m)).astype(np.float32)
        A[f] = X @ X.T + 3.0 * np.eye(m)
    B = 0.25 * rng.normal(size=(Fl - 1, m, m)).astype(np.float32)
    if warm == "warm":
        # perturbed true inverses: the LM steady state, guard passes
        X0 = np.linalg.inv(A[1::2].astype(np.float64)) * (1 + 1e-3)
    elif warm == "garbage":
        X0 = 100.0 * np.ones((Fl // 2, m, m))
    else:                                          # "nan"
        X0 = np.linalg.inv(A[1::2].astype(np.float64))
        X0[0, 1, 2] = np.nan
    return A, B, X0.astype(np.float32)


def _reference(A, B, X0):
    with jax.default_matmul_precision("highest"):
        a, b, x = map(jnp.asarray, (A, B, X0))
        return ([np.asarray(v) for v in fused_reduction_level(a, b, x)],
                [np.asarray(v) for v in _xla_level(a, b, x)])


def _plain(A, B, X0):
    out = tfl.fused_reduction_level_ref(*map(torch.from_numpy, (A, B, X0)))
    return [v.numpy() for v in out]


@pytest.mark.parametrize("Fl,m,warm", [(8, 8, "warm"), (16, 16, "warm"),
                                       (8, 40, "warm"), (8, 8, "garbage"),
                                       (8, 40, "nan"), (8, 80, "warm"),
                                       (8, 80, "garbage")])
def test_plain_level_matches_jax(Fl, m, warm):
    rng = np.random.default_rng(Fl * 100 + m)
    A, B, X0 = _random_level(rng, Fl, m, warm)
    pallas, xla = _reference(A, B, X0)
    got = _plain(A, B, X0)
    for name, g, p, x in zip(NAMES, got, pallas, xla):
        assert g.shape == p.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, p, err_msg=f"{name} vs Pallas", **TOL)
        np.testing.assert_allclose(g, x, err_msg=f"{name} vs XLA", **TOL)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(2)
    A, B, X0 = map(torch.from_numpy, _random_level(rng, 8, 8))
    calls, launches = (tfl.fused_reduction_level_ref.calls,
                       tfl.fused_reduction_level.launches)
    got = tfl.fused_reduction_level(A, B, X0)
    assert tfl.fused_reduction_level_ref.calls == calls + 1
    assert tfl.fused_reduction_level.launches == launches
    ref = tfl.fused_reduction_level_ref(A, B, X0)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_kernel_wrapper_rejects_cpu_tensors():
    from omniswarm_torch import kernels

    A = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_level(A, A[:7].contiguous(), A[:4].contiguous(), 0.95)
    with pytest.raises(ValueError, match="exceeds"):
        big = torch.zeros((2, 88, 88))
        kernels.fused_level(big, big[:1], big[:1], 0.95)


def test_kernel_wrapper_rejects_padded_b():
    """The kernel takes B as (Fl-1, m, m) and zeroes the last pair's
    B_right itself: a B padded to Fl blocks is refused."""
    from omniswarm_torch import kernels

    A = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="unpadded"):
        kernels.fused_level(A, A, A[:4].contiguous(), 0.95)


def test_kernel_wrapper_rejects_misaligned_blocks():
    """At m % 4 == 0 the kernel loads A, B and X0 16 bytes at a time: a
    contiguous view that starts one element into its storage is refused
    before it could fault on the card."""
    from omniswarm_torch import kernels

    flat = torch.zeros(8 * 8 * 8 + 1)
    A = flat[:512].view(8, 8, 8)
    X0 = torch.zeros((4, 8, 8))
    shifted = flat[1:].view(8, 8, 8)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.fused_level(shifted, A[:7], X0, 0.95)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.fused_level(A, shifted[:7], X0, 0.95)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.fused_level(A, A[:7], shifted[:4], 0.95)
