"""Port vs reference: the front-end kernels K2 (grid NMS) and K3 (top-1
retrieval).

The plain PyTorch versions are held against the JAX Pallas kernels
(interpret mode on CPU) and the XLA ops: NMS exactly (a max does no
arithmetic), retrieval with the same index and the similarity within 1e-5.
The CUDA kernels are held against the plain versions on a card by
tests/test_torch_kernels_card.py, on the inputs of tests/kernel_inputs.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.ops import frontend_kernels as fk
from omniswarm_torch.ops import keypoints as tkp
from omniswarm_tpu.ops import keypoints as jkp
from omniswarm_tpu.ops.pallas_kernels import (grid_nms_pallas,
                                              retrieval_top1_pallas)

from kernel_inputs import NMS_EDGE_CASES, heat_map, unit_rows

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,r,kind", [
    ((2, 64, 128), 4, "random"), ((3, 40, 70), 4, "plateau"),
    ((1, 48, 96), 2, "plateau"), ((2, 33, 65), 1, "random")]
    + NMS_EDGE_CASES)
def test_plain_nms_matches_pallas_and_xla(shape, r, kind):
    heat = heat_map(np.random.default_rng(sum(shape) + r), *shape, kind)
    got = fk.grid_nms_ref(torch.from_numpy(heat), r).numpy()
    for b in range(shape[0]):
        pallas = np.asarray(grid_nms_pallas(jnp.asarray(heat[b]),
                                            nms_dist=r))
        xla = np.asarray(jkp.grid_nms(jnp.asarray(heat[b]), r))
        np.testing.assert_array_equal(got[b], pallas)
        np.testing.assert_array_equal(got[b], xla)
    assert not np.isnan(got).any()
    if kind == "plateau":
        # ties keep every cell whose window lies inside the plateau
        assert (got[:, 4 + r:20 - r, 8 + r:30 - r] == 0.5).all()
        assert (got[:, 0, 0] == 1.0).all() and (got[:, -1, -1] == 1.0).all()


def test_nms_dispatch_takes_plain_version_on_cpu():
    heat = torch.from_numpy(heat_map(np.random.default_rng(1), 2, 32, 48,
                                     "random"))
    calls, launches = fk.grid_nms_ref.calls, fk.grid_nms.launches
    got = tkp.grid_nms(heat, 4)
    assert fk.grid_nms_ref.calls == calls + 1
    assert fk.grid_nms.launches == launches
    assert torch.equal(got, fk.grid_nms_ref(heat, 4))


def _pallas_top1(db, q, mask):
    best, sim = retrieval_top1_pallas(jnp.asarray(db), jnp.asarray(q),
                                      jnp.asarray(mask))
    return int(best), float(sim)


@pytest.mark.parametrize("N,D,case", [
    (256, 128, "full"), (512, 128, "partial"), (512, 64, "tie"),
    (256, 32, "all_masked"), (1000, 130, "ragged"), (1100, 130, "tie_far")])
def test_plain_retrieval_matches_pallas(N, D, case):
    rng = np.random.default_rng(N + D)
    db = unit_rows(rng, N, D)
    Q = 3
    q = db[[37, 300 % N, 5]] + rng.normal(0, 0.05, size=(Q, D))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    mask = np.ones((Q, N), bool)
    if case == "partial":
        mask[:, ::3] = False
        mask[0, 37] = False                       # the true hit is guarded
    elif case == "tie":
        db[400] = db[100]                         # planted equal maxima
        q[1] = db[100]                            # across 256-row chunks
        db[20] = db[10]
        q[2] = db[10]                             # within a chunk
    elif case == "all_masked":
        mask[:] = False
    elif case == "ragged":                        # a hit in the last,
        q[2] = db[N - 1]                          # partial 256-row chunk
        mask[:, 1::4] = False
    elif case == "tie_far":
        db[1050] = db[50]                         # equal rows 1000 apart,
        q[1] = db[50]                             # first and last chunk
    idx, sim = fk.retrieval_top1_ref(torch.from_numpy(db),
                                     torch.from_numpy(q),
                                     torch.from_numpy(mask))
    for j in range(Q):
        best, s = _pallas_top1(db, q[j], mask[j])
        assert int(idx[j]) == best, (case, j)
        if np.isfinite(s):
            np.testing.assert_allclose(float(sim[j]), s, rtol=0, atol=1e-5)
        else:
            assert float(sim[j]) == s == -np.inf
    if case == "tie":
        assert int(idx[1]) == 100 and int(idx[2]) == 10
    if case == "ragged":
        assert int(idx[2]) == N - 1
    if case == "tie_far":
        assert int(idx[1]) == 50
    if case == "all_masked":
        assert (idx == 0).all() and torch.isneginf(sim).all()


def test_retrieval_dispatch_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    db = torch.from_numpy(unit_rows(rng, 64, 16))
    q = db[:2].clone()
    mask = torch.ones((2, 64), dtype=torch.bool)
    calls, launches = fk.retrieval_top1_ref.calls, fk.retrieval_top1.launches
    idx, sim = fk.retrieval_top1(db, q, mask)
    assert fk.retrieval_top1_ref.calls == calls + 1
    assert fk.retrieval_top1.launches == launches
    assert idx.tolist() == [0, 1]


def test_kernel_wrappers_reject_cpu_tensors():
    from omniswarm_torch import kernels

    with pytest.raises(ValueError, match="CUDA"):
        kernels.grid_nms(torch.zeros((1, 8, 8)), 4)
    with pytest.raises(ValueError, match="nms_dist"):
        kernels.grid_nms(torch.zeros((1, 8, 8)), 17)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.retrieval_top1(torch.zeros((4, 8)), torch.zeros((1, 8)),
                               torch.ones((1, 4), dtype=torch.bool))


@pytest.mark.parametrize("db_shape,q_shape,mask_shape,match", [
    ((4, 8), (8,), (1, 4), "2-D"),
    ((0, 8), (1, 8), (1, 0), "not supported"),
    ((4, 8), (0, 8), (0, 4), "not supported"),
    ((4, 8), (65536, 8), (65536, 4), "not supported")])
def test_retrieval_wrapper_rejects_bad_shapes(db_shape, q_shape, mask_shape,
                                              match):
    from omniswarm_torch import kernels

    with pytest.raises(ValueError, match=match):
        kernels.retrieval_top1(torch.zeros(db_shape), torch.zeros(q_shape),
                               torch.ones(mask_shape, dtype=torch.bool))
