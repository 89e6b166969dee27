"""K1, K2 and K3 on a card, against the port's plain versions.

K1 is the fused cyclic-reduction level (csrc/fused_level.cu), K2 grid NMS
(csrc/grid_nms.cu), K3 top-1 retrieval (csrc/retrieval_top1.cu). Their
plain versions (``fused_reduction_level_ref``, ``grid_nms_ref``,
``retrieval_top1_ref``) are held against the JAX package on the CPU by
tests/test_torch_fused_level.py and tests/test_torch_frontend_kernels.py.
Every test here is marked ``cuda`` and skips without a card:

- K1 within rtol = atol = 2e-4 on its seven outputs, each finite, at every
  level shape the solves launch (``benchutil.SOLVE_LEVELS``: m = 40 with
  t = 32 ... 4, m = 80 with t = 2,048 ... 4), at widths other than 40 and
  80, ragged panels and single pairs, each on the warm, guard-fallback and
  NaN-start branches; one launch a call; the cluster-size rule.
- K2 bit-exact at the path's batches (the 5- and 10-drone keyframe steps,
  the bench's and the training path's), with NaN cells, plateaus, r = 0 to
  16, W % 4 != 0, maps smaller than their window or wider than a column
  tile, and views 4 bytes off 16; 16-byte loads exactly where the rows
  allow them.
- K3 at the PlaceDB's 4,096 rows and the demo's 512, Q = 1 to 9, ragged N
  and D % 4 != 0: equal indices, planted ties to the lower row (across
  CTAs and inside one row tile), (0, -inf) for an all-masked query,
  similarities within 1e-5 relative.

The file imports no JAX, so it runs on a card without it:
``python -m pytest --noconftest tests/test_torch_kernels_card.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from omniswarm_torch import kernels
from omniswarm_torch.benchutil import SOLVE_LEVELS, random_level
from omniswarm_torch.core.precision import highp
from omniswarm_torch.ops import frontend_kernels as fk
from omniswarm_torch.solver import fused_level as tfl

from kernel_inputs import NMS_EDGE_CASES, heat_map, unit_rows

torch.set_num_threads(1)

NAMES = ("Ainv", "B_left", "B_right", "W_l", "W_r", "A_new", "B_new")
TOL = dict(rtol=2e-4, atol=2e-4)
K1_BRANCHES = ("warm", "fallback", "nan")
# the solves' level shapes, then widths other than 40 and 80 (the run-time
# m instantiation), ragged and empty panels and single pairs
K1_SHAPES = tuple(dict.fromkeys(
    (m, t) for _, _, m, ts in SOLVE_LEVELS for t in ts)) + (
    (12, 2), (48, 8), (60, 3), (7, 5), (1, 1), (40, 1), (80, 1))
# the path's batches of 208 x 400 maps: the 5- and 10-drone keyframe steps
# and the bench's front-end rows
NMS_STEPS = [(40, 208, 400), (80, 208, 400), (4, 208, 400), (8, 208, 400),
             (16, 208, 400), (64, 208, 400)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("branch", K1_BRANCHES)
@pytest.mark.parametrize("m,t", K1_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, record_property, m, t,
                                      branch):
    rng = np.random.default_rng(m + t)
    A, B, X0 = (torch.from_numpy(v).to(cuda_device)
                for v in random_level(rng, 2 * t, m, branch))
    launches = tfl.fused_reduction_level.launches
    with highp():
        got = tfl.fused_reduction_level(A, B, X0)
        ref = tfl.fused_reduction_level_ref(A, B, X0)
    torch.cuda.synchronize()
    assert tfl.fused_reduction_level.launches == launches + 1
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   err_msg=name, **TOL)
    record_property("max_abs_err", max(float((g - r).abs().max())
                                       for g, r in zip(got, ref)
                                       if g.numel()))


@pytest.mark.cuda
def test_cluster_size_rule_on_card(cuda_device):
    """One wave of at most one CTA per SM: t = 128 pairs of 80-wide blocks
    run one CTA each, the path's small levels a cluster of 8."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert kernels.fused_level_cluster(80, 128) == 1
    assert kernels.fused_level_cluster(80, 4) == 8
    assert kernels.fused_level_cluster(40, 4) == 8
    assert kernels.fused_level_cluster(1, 4) == 1
    for m in (40, 80):
        for t in (128, 64, 32, 16, 8, 4):
            c = kernels.fused_level_cluster(m, t)
            assert c in (1, 2, 4, 8) and (c == 1 or t * c <= sms)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r,kind,aligned", [
    ((40, 208, 400), 4, "random", True), ((3, 40, 70), 4, "plateau", True),
    ((2, 33, 65), 1, "random", True), ((1, 100, 37), 16, "plateau", True),
    ((2, 40, 1200), 4, "random", True), ((3, 40, 64), 4, "random", False),
    ((2, 40, 64), 7, "nan", False), ((2, 40, 64), 7, "nan", True),
    ((1, 50, 1000), 16, "random", True)]
    + [(*case, True) for case in NMS_EDGE_CASES]
    # the training path's maps; unaligned views of a step and of wide maps;
    # run-time radii on wide maps with NaN
    + [((1, 64, 96), 4, "random", True), ((16, 64, 96), 4, "nan", True),
       ((40, 208, 400), 4, "random", False), ((3, 40, 64), 4, "nan", False),
       ((1, 50, 1000), 16, "random", False), ((2, 40, 1000), 16, "nan", True)]
    + [(shape, 4, kind, True) for shape in NMS_STEPS[1:]
       for kind in ("random", "nan")]
    + [(NMS_STEPS[0], 4, "nan", True)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_nms_kernel_bit_exact_on_card(cuda_device, shape, r, kind, aligned):
    heat = torch.from_numpy(heat_map(np.random.default_rng(7), *shape,
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
    # 16-byte loads where the rows allow them, 4-byte ones elsewhere
    assert kernels.grid_nms_vector_width(heat, got) == (
        4 if aligned and shape[-1] % 4 == 0 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,Q,aligned", [
    (4096, 4096, 5, True), (512, 4096, 1, True), (1000, 130, 9, True),
    (4096, 4096, 1, True), (4096, 4096, 8, True), (512, 4096, 5, True),
    (512, 4096, 5, False), (37, 64, 17, False)])
def test_retrieval_kernel_matches_plain_on_card(cuda_device, record_property,
                                                N, D, Q, aligned):
    rng = np.random.default_rng(N + Q)
    db = unit_rows(rng, N, D)
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
    live = torch.isfinite(rsim)
    record_property("max_rel_err", float(
        ((sim - rsim)[live].abs() / rsim[live].abs()).max()))
