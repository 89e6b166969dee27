"""Batched homography RANSAC: the geometric pre-filter of descriptor matches.

Counterpart of ``omniswarm_tpu/ops/homography.py`` (:23-125), batched over a
leading lane axis instead of vmapped: H hypotheses per lane, each a 4-point
DLT (h33 = 1) solved from conditioned points as one 8x8 normal-equation
solve, denormalised, scored by forward transfer error in pixels; then one
least-squares refit on the best hypothesis' inliers, kept if it loses no
inlier and is finite. Sampling is Gumbel-max over the valid rows with the
noise given as an argument, as in ``ops/ransac.py``; solves use
``torch.linalg.solve_ex`` (a degenerate, e.g. collinear, sample gives a
poor or non-finite model that loses the vote).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from omniswarm_torch.ops.ransac import _norm, _solve, sample_indices


class HomographyResult(NamedTuple):
    H: torch.Tensor            # (B, 3, 3) best homography (a -> b)
    inliers: torch.Tensor      # (B, K) bool
    num_inliers: torch.Tensor  # (B,) int64


def _dlt_rows(pa: torch.Tensor, pb: torch.Tensor):
    """Two DLT rows per correspondence, interleaved per point:
    [x y 1 0 0 0 -x'x -x'y] h = x' ;  [0 0 0 x y 1 -y'x -y'y] h = y'.
    pa, pb (..., N, 2) -> A (..., 2N, 8), b (..., 2N)."""
    x, y = pa[..., 0], pa[..., 1]
    xp, yp = pb[..., 0], pb[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -xp * x, -xp * y], -1)
    r2 = torch.stack([z, z, z, x, y, o, -yp * x, -yp * y], -1)
    A = torch.stack([r1, r2], -2).flatten(-3, -2)
    b = torch.stack([xp, yp], -1).flatten(-2)
    return A, b


def _transfer_err(H: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor):
    """Forward transfer error |H pa - pb| in pixels: H (..., 3, 3), pa/pb
    (..., K, 2) broadcast against it -> (..., K); inf where the point maps
    to infinity (or H is not finite)."""
    ph = torch.cat([pa, torch.ones_like(pa[..., :1])], -1)
    q = torch.einsum("...ij,...kj->...ki", H, ph)
    w = q[..., 2]
    far = torch.abs(w) > 1e-8
    proj = q[..., :2] / torch.where(far, w, 1e-8)[..., None]
    err = _norm(proj - pb)
    return torch.where(far, err, float("inf"))


def _hom_from_h(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).unflatten(
        -1, (3, 3))


def homography_ransac(pts_a: torch.Tensor, pts_b: torch.Tensor,
                      valid: torch.Tensor, noise: torch.Tensor, *,
                      err_thresh: float = 3.0) -> HomographyResult:
    """pts_a/pts_b (B, K, 2) pixel coords of the matched points, valid
    (B, K) bool, noise (B, H, 4, K) Gumbel noise; err_thresh in pixels
    (cv::findHomography(..., 3, ...))."""
    B, K = valid.shape
    dtype, dev = pts_a.dtype, pts_a.device
    idx = sample_indices(noise, valid)                   # (B, H, 4)
    nh = idx.shape[1]
    take = lambda p: torch.gather(
        p[:, None].expand(B, nh, K, 2), 2,
        idx[..., None].expand(B, nh, 4, 2))
    sa, sb = take(pts_a), take(pts_b)                    # (B, H, 4, 2)

    # normalise for conditioning (a unit box around the centroid)
    ca = sa.mean(2, keepdim=True)
    cb = sb.mean(2, keepdim=True)
    scale_a = torch.clamp(torch.abs(sa - ca).mean((2, 3)), min=1e-3)
    scale_b = torch.clamp(torch.abs(sb - cb).mean((2, 3)), min=1e-3)
    na = (sa - ca) / scale_a[..., None, None]
    nb = (sb - cb) / scale_b[..., None, None]

    A, b = _dlt_rows(na, nb)                             # (B, H, 8, 8)
    # a tiny ridge keeps degenerate (collinear) samples finite; they lose
    # the inlier vote
    eye8 = torch.eye(8, dtype=dtype, device=dev)
    AtA = torch.einsum("...ij,...ik->...jk", A, A) + 1e-8 * eye8
    Atb = torch.einsum("...ij,...i->...j", A, b)
    Hn = _hom_from_h(_solve(AtA, Atb))                   # (B, H, 3, 3)
    # denormalise: H = T_b^-1 Hn T_a
    one, zero = torch.ones_like(scale_a), torch.zeros_like(scale_a)
    ca, cb = ca[:, :, 0], cb[:, :, 0]
    Ta = torch.stack([
        torch.stack([1 / scale_a, zero, -ca[..., 0] / scale_a], -1),
        torch.stack([zero, 1 / scale_a, -ca[..., 1] / scale_a], -1),
        torch.stack([zero, zero, one], -1)], -2)
    Tbinv = torch.stack([
        torch.stack([scale_b, zero, cb[..., 0]], -1),
        torch.stack([zero, scale_b, cb[..., 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)
    H_all = Tbinv @ Hn @ Ta

    err = _transfer_err(H_all, pts_a[:, None], pts_b[:, None])   # (B, H, K)
    inl = (err < err_thresh) & valid[:, None]
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)
    lane = torch.arange(B, device=dev)
    Hb, inl_b, score_b = H_all[lane, best], inl[lane, best], scores[lane,
                                                                    best]

    # one least-squares refit on the best hypothesis' inliers
    Af, bf = _dlt_rows(pts_a, pts_b)                     # (B, 2K, 8)
    wf = torch.repeat_interleave(inl_b.to(dtype), 2, dim=-1)
    Aw = Af * wf[..., None]
    AtA = torch.einsum("bij,bik->bjk", Aw, Af) + 1e-6 * eye8
    Atb = torch.einsum("bij,bi->bj", Aw, bf)
    Hf = _hom_from_h(_solve(AtA, Atb))
    inl_f = (_transfer_err(Hf, pts_a, pts_b) < err_thresh) & valid
    use_f = (inl_f.sum(-1) >= score_b) & torch.isfinite(Hf).all((-2, -1))
    H_out = torch.where(use_f[:, None, None], Hf, Hb)
    inliers = torch.where(use_f[:, None], inl_f, inl_b)
    return HomographyResult(H=H_out, inliers=inliers,
                            num_inliers=inliers.sum(-1))
