"""Port vs reference: the front-end kernels K2 (grid NMS) and K3 (top-1
retrieval).

The plain PyTorch versions are held against the JAX Pallas kernels
(interpret mode on CPU) and the XLA ops: NMS exactly (a max does no
arithmetic), retrieval with the same index and the similarity within 1e-5.
The CUDA kernels are held against the plain versions on a card (marked
``cuda``; they skip here): NMS bit-exact, retrieval with equal indices and
similarities within 1e-5 relative.
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

torch.set_num_threads(1)


def _heat(rng, B, H, W, kind):
    h = (rng.uniform(size=(B, H, W)) ** 8).astype(np.float32)
    if kind == "plateau":
        h[:, 4:20, 8:30] = 0.5                    # one flat maximum region
        h[:, 30:33, 40:43] = 0.25                 # a flat peak
        h[:, 0, 0] = 1.0                          # corners and edges
        h[:, -1, -1] = 1.0
        h[:, -1, 5] = 0.75
    elif kind == "nan":
        B, H, W = h.shape
        h[:, H // 2, W // 3] = np.nan             # inside, a corner and
        h[:, 0, W - 1] = np.nan                   # an edge: every window
        h[:, H - 1, W // 2] = np.nan              # that holds one gives 0
        h[:, rng.integers(0, H, 3), rng.integers(0, W, 3)] = np.nan
    return h


# edge cases of the window: NaN cells, r = 0, a map smaller than its window,
# the largest radius with NaN
NMS_EDGE_CASES = [((2, 40, 64), 4, "nan"), ((2, 33, 65), 0, "random"),
                  ((1, 7, 5), 4, "random"), ((1, 20, 37), 16, "nan")]


@pytest.mark.parametrize("shape,r,kind", [
    ((2, 64, 128), 4, "random"), ((3, 40, 70), 4, "plateau"),
    ((1, 48, 96), 2, "plateau"), ((2, 33, 65), 1, "random")]
    + NMS_EDGE_CASES)
def test_plain_nms_matches_pallas_and_xla(shape, r, kind):
    heat = _heat(np.random.default_rng(sum(shape) + r), *shape, kind)
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
    heat = torch.from_numpy(_heat(np.random.default_rng(1), 2, 32, 48,
                                  "random"))
    calls, launches = fk.grid_nms_ref.calls, fk.grid_nms.launches
    got = tkp.grid_nms(heat, 4)
    assert fk.grid_nms_ref.calls == calls + 1
    assert fk.grid_nms.launches == launches
    assert torch.equal(got, fk.grid_nms_ref(heat, 4))


def _db(rng, N, D):
    db = rng.normal(size=(N, D)).astype(np.float32)
    return db / np.linalg.norm(db, axis=1, keepdims=True)


def _pallas_top1(db, q, mask):
    best, sim = retrieval_top1_pallas(jnp.asarray(db), jnp.asarray(q),
                                      jnp.asarray(mask))
    return int(best), float(sim)


@pytest.mark.parametrize("N,D,case", [
    (256, 128, "full"), (512, 128, "partial"), (512, 64, "tie"),
    (256, 32, "all_masked"), (1000, 130, "ragged"), (1100, 130, "tie_far")])
def test_plain_retrieval_matches_pallas(N, D, case):
    rng = np.random.default_rng(N + D)
    db = _db(rng, N, D)
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
    db = torch.from_numpy(_db(rng, 64, 16))
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r,kind,aligned", [
    ((40, 208, 400), 4, "random", True), ((3, 40, 70), 4, "plateau", True),
    ((2, 33, 65), 1, "random", True), ((1, 100, 37), 16, "plateau", True),
    ((2, 40, 1200), 4, "random", True), ((3, 40, 64), 4, "random", False),
    ((2, 40, 64), 7, "nan", False), ((2, 40, 64), 7, "nan", True),
    ((1, 50, 1000), 16, "random", True)]
    + [(*case, True) for case in NMS_EDGE_CASES])
def test_nms_kernel_bit_exact_on_card(cuda_device, shape, r, kind, aligned):
    heat = torch.from_numpy(_heat(np.random.default_rng(7), *shape,
                                  kind)).to(cuda_device)
    if not aligned:                               # a view 4 bytes off 16
        view = torch.empty(heat.numel() + 1, device=cuda_device)[1:]
        heat = view.view(shape).copy_(heat)
    launches = fk.grid_nms.launches
    got = fk.grid_nms(heat, r)
    ref = fk.grid_nms_ref(heat, r)
    torch.cuda.synchronize()
    assert fk.grid_nms.launches == launches + 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,Q,aligned", [
    (4096, 4096, 5, True), (512, 4096, 1, True), (1000, 130, 9, True),
    (4096, 4096, 1, True), (4096, 4096, 8, True), (512, 4096, 5, True),
    (512, 4096, 5, False), (37, 64, 17, False)])
def test_retrieval_kernel_matches_plain_on_card(cuda_device, N, D, Q,
                                                aligned):
    from omniswarm_torch.core.precision import highp

    rng = np.random.default_rng(N + Q)
    db = _db(rng, N, D)
    # planted ties, (query, lower row): rows N//2 and N-1; for Q >= 4 rows
    # 3 and 4 (row tiles 0 and 1 of the kernel, two CTAs) and rows 8 and 9
    # (one tile)
    pairs = [(N // 2, N - 1)] + ([(3, 4), (8, 9)] if Q >= 4 else [])
    for a, b in pairs:
        db[b] = db[a]
    q = db[rng.integers(0, N, size=Q)] + rng.normal(0, 0.05, size=(Q, D))
    for j, (a, _) in enumerate(pairs):
        q[j] = db[a]
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    mask = rng.uniform(size=(Q, N)) > 0.3
    mask[:, [row for pair in pairs for row in pair]] = True
    if Q > 1:
        mask[-1] = False                          # one all-masked query
    args = [torch.from_numpy(v).to(cuda_device) for v in (db, q, mask)]
    if not aligned:                               # a query 4 bytes off 16
        qa = torch.empty(Q * D + 1, device=cuda_device)[1:].view(Q, D)
        args[1] = qa.copy_(args[1])
    launches = fk.retrieval_top1.launches
    with highp():
        idx, sim = fk.retrieval_top1(*args)
        ridx, rsim = fk.retrieval_top1_ref(*args)
    torch.cuda.synchronize()
    assert fk.retrieval_top1.launches == launches + 1
    assert torch.equal(idx, ridx)
    for j, (a, _) in enumerate(pairs):
        assert int(idx[j]) == a
    if Q > 1:
        assert int(idx[-1]) == 0 and bool(torch.isneginf(sim[-1]))
    torch.testing.assert_close(sim, rsim, rtol=1e-5, atol=0)
