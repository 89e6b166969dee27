"""Batched 4-DoF PnP RANSAC: the geometric-verification core of loop closure.

Counterpart of ``omniswarm_tpu/ops/ransac.py`` (:24-160), batched over a
leading lane axis (one lane per (query, candidate) pair) instead of vmapped.
Model: 3-D points p_k in keyframe B's gravity-aligned body frame, seen as
unit bearings u_k in keyframe A's body frame; the 4-DoF transform (t, yaw)
with u_k parallel to R(yaw) p_k + t. The constraint u x (R p + t) = 0 is
linear in v = [cos yaw, sin yaw, tx, ty, tz], so each hypothesis is a 5x5
normal-equation solve, followed by a 3x3 solve for t at the projected yaw.

Sampling is the reference's ``jax.random.categorical``, which is Gumbel-max:
each hypothesis' 4 sample indices are ``argmax(noise + logits)`` over the K
rows, with logits 0 on valid rows and -inf elsewhere. The noise is an
argument (``gumbel_noise`` draws it from a ``torch.Generator``), so a test
can pass JAX's own draw and compare hypothesis for hypothesis. A row drawn
twice counts once in the hypothesis' weights, as the reference's
``w.at[idx].set(1.0)``. Linear solves use ``torch.linalg.solve_ex``: a
singular or non-finite system gives non-finite values that lose the vote,
never an exception or a host sync. Every product runs in true float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PnPResult(NamedTuple):
    dpose: torch.Tensor        # (B, 4) [tx, ty, tz, yaw]: B expressed in A
    inliers: torch.Tensor      # (B, K) bool
    num_inliers: torch.Tensor  # (B,) int64
    mean_err: torch.Tensor     # (B,) mean angular error (1 - cos) of inliers


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device="cpu") -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in float32 from ``generator``
    (the form of ``jax.random.gumbel``: -log(-log(u)), u in [tiny, 1))."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_indices(noise: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, H, S) categorical draws over the valid rows: ``noise`` (B, H, S,
    K) plus logits 0 / -inf, argmax over K (the first of equal maxima)."""
    logits = torch.where(valid, 0.0, float("-inf")).to(noise.dtype)
    return torch.argmax(noise + logits[:, None, None, :], dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last (short) axis, as sqrt(sum(v^2)):
    ``vector_norm`` over an axis of 2 or 3 is slow on the CPU."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _constraint_rows(points: torch.Tensor, bearings: torch.Tensor):
    """Linear system rows A (..., K, 3, 5), b (..., K, 3) for
    u x (R p + t) = 0 in the unknowns [c, s, tx, ty, tz]."""
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    ux, uy, uz = bearings[..., 0], bearings[..., 1], bearings[..., 2]
    zero = torch.zeros_like(px)
    a1 = torch.stack([-uz * py, -uz * px, zero, -uz, uy], -1)
    b1 = -uy * pz
    a2 = torch.stack([uz * px, -uz * py, uz, zero, -ux], -1)
    b2 = ux * pz
    a3 = torch.stack([ux * py - uy * px, ux * px + uy * py, -uy, ux, zero],
                     -1)
    b3 = zero
    return torch.stack([a1, a2, a3], -2), torch.stack([b1, b2, b3], -1)


def _solve(AtA: torch.Tensor, Atb: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(AtA, Atb[..., None],
                                 check_errors=False)[0][..., 0]


def _solve_weighted(A: torch.Tensor, b: torch.Tensor, w: torch.Tensor):
    """Weighted least squares for v = [c, s, tx, ty, tz] of each weight
    row: A (B, K, 3, 5), b (B, K, 3), w (B, M, K) -> yaw (B, M)."""
    w2 = w * w
    AtA = torch.einsum("bmk,bkij->bmij", w2,
                       torch.einsum("bkri,bkrj->bkij", A, A))
    AtA = AtA + 1e-8 * torch.eye(5, dtype=A.dtype, device=A.device)
    Atb = torch.einsum("bmk,bki->bmi", w2, torch.einsum("bkri,bkr->bki",
                                                        A, b))
    v = _solve(AtA, Atb)
    # project (c, s) onto the unit circle; t is re-solved at this yaw
    return torch.atan2(v[..., 1], v[..., 0])


def _rotate(points: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """R(yaw) p for every yaw: points (B, K, 3), yaw (B, M) -> (B, M, K, 3)."""
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    px, py = points[:, None, :, 0], points[:, None, :, 1]
    pz = points[:, None, :, 2].expand(c.shape[:2] + points.shape[1:2])
    return torch.stack([c * px - s * py, s * px + c * py, pz], -1)


def _cross_matrix(u: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(u[..., 0])
    return torch.stack([
        torch.stack([zero, -u[..., 2], u[..., 1]], -1),
        torch.stack([u[..., 2], zero, -u[..., 0]], -1),
        torch.stack([-u[..., 1], u[..., 0], zero], -1),
    ], -2)                                              # (B, K, 3, 3)


def _refine_t(points, bearings, w, yaw):
    """Given yaw (B, M), least-squares t (B, M, 3) from u x (R p + t) = 0
    with weights w (B, M, K)."""
    rp = _rotate(points, yaw)                            # (B, M, K, 3)
    ux = _cross_matrix(bearings)                         # (B, K, 3, 3)
    w2 = w * w
    AtA = torch.einsum("bmk,bkij->bmij", w2,
                       torch.einsum("bkri,bkrj->bkij", ux, ux))
    AtA = AtA + 1e-8 * torch.eye(3, dtype=points.dtype, device=points.device)
    rhs = -torch.einsum("bkij,bmkj->bmki", ux, rp)       # -[u]_x R p
    Atb = torch.sum(w2[..., None]
                    * torch.einsum("bkri,bmkr->bmki", ux, rhs), dim=2)
    return _solve(AtA, Atb)


def _score(points, bearings, valid, yaw, t, cos_thresh):
    """Inliers and cosines of each (yaw, t): (B, M, K)."""
    w = _rotate(points, yaw) + t[:, :, None, :]
    wn = w / torch.clamp(_norm(w)[..., None], min=1e-9)
    cosang = torch.sum(wn * bearings[:, None], dim=-1)
    return (cosang > cos_thresh) & valid[:, None], cosang


def pnp_ransac_4dof(points: torch.Tensor, bearings: torch.Tensor,
                    valid: torch.Tensor, noise: torch.Tensor, *,
                    err_thresh: float = 0.03) -> PnPResult:
    """Batched 4-DoF PnP RANSAC with the reference's LO refinement.

    points (B, K, 3) in frame B; bearings (B, K, 3) unit, in frame A;
    valid (B, K) bool; noise (B, H, 4, K) Gumbel noise of the H hypotheses'
    4-point samples. err_thresh is the angular inlier gate in radians.
    """
    dtype = points.dtype
    B, K = valid.shape
    cos_thresh = torch.cos(_f32(err_thresh, points))
    A, b = _constraint_rows(points, bearings)
    validf = valid.to(dtype)

    idx = sample_indices(noise, valid)                   # (B, H, 4)
    H = idx.shape[1]
    w = torch.zeros((B, H, K), dtype=dtype, device=points.device)
    w.scatter_(-1, idx, 1.0)                             # duplicates once
    w = w * validf[:, None]
    yaws = _solve_weighted(A, b, w)                      # (B, H)
    ts = _refine_t(points, bearings, w, yaws)            # (B, H, 3)
    inl, _ = _score(points, bearings, valid, yaws, ts, cos_thresh)
    best = torch.argmax(inl.sum(-1), dim=-1)             # (B,)
    lane = torch.arange(B, device=points.device)
    yaw, t = yaws[lane, best][:, None], ts[lane, best][:, None]

    # annealed inlier-weighted refinement (LO-RANSAC): each round re-fits
    # on the inliers of a tighter gate and keeps the new model only if it
    # loses no base-gate inliers
    for shrink in (1.0, 0.5, 0.25):
        thr = torch.cos(_f32(err_thresh * shrink, points))
        inl_r, _ = _score(points, bearings, valid, yaw, t, thr)
        wr = inl_r.to(dtype)                             # (B, 1, K)
        enough = wr.sum(-1)[:, 0] >= 4
        yaw2 = _solve_weighted(A, b, wr)
        t2 = _refine_t(points, bearings, wr, yaw2)
        inl_old, _ = _score(points, bearings, valid, yaw, t, cos_thresh)
        inl_new, _ = _score(points, bearings, valid, yaw2, t2, cos_thresh)
        better = (enough & (inl_new.sum(-1)[:, 0] >= inl_old.sum(-1)[:, 0])
                  & torch.isfinite(t2[:, 0]).all(-1)
                  & torch.isfinite(yaw2[:, 0]))
        yaw = torch.where(better[:, None], yaw2, yaw)
        t = torch.where(better[:, None, None], t2, t)

    inliers, cosang = _score(points, bearings, valid, yaw, t, cos_thresh)
    inliers, cosang = inliers[:, 0], cosang[:, 0]
    n_inl = inliers.sum(-1)
    mean_err = torch.where(inliers, 1.0 - cosang, 0.0).sum(-1) / torch.clamp(
        n_inl, min=1)
    dpose = torch.cat([t[:, 0], yaw], -1)
    return PnPResult(dpose=dpose, inliers=inliers, num_inliers=n_inl,
                     mean_err=mean_err)
