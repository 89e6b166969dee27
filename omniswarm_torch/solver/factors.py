"""Residual functions of the 4-DoF swarm factor graph and their Jacobians.

Counterpart of ``omniswarm_tpu/solver/factors.py``. Each residual takes two
4-DoF poses ``[x, y, z, yaw]`` and measurement constants and returns a
fixed-size whitened residual:

- ``range_residual`` (dim 1) and ``range_residual_antenna`` (between
  body-frame UWB antenna points);
- ``relpose_residual`` (dim 4: ego-motion chains, loop edges);
- ``detection_residual`` (dim 3: tangent-plane bearing + masked inverse
  depth).

The ``*_eval`` functions evaluate a batch of factors with their (dim, 4)
pose Jacobians by forward-mode autodiff (``torch.func.jacfwd`` under
``torch.func.vmap``), the same computation as the reference's
``jax.jacfwd`` under ``jax.vmap``: the generic and dense gold paths are the
oracle for the analytic Jacobians of ``solver/dense.py``, so they must not
share them. The residuals are functional (no in-place ops, no host reads),
as the transforms require; their norms keep a length-1 axis, since under
``jacfwd`` a 0-d dual times or over a Python float promotes its tangent to
float64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from omniswarm_torch.core import geometry as geo

RANGE_DIM = 1
RELPOSE_DIM = 4
DET_DIM = 3  # 2 tangent-plane + 1 inv-depth (masked when depth disabled)


def range_residual(pose_a, pose_b, distance, sqrt_inf):
    """Whitened UWB range residual (||p_a - p_b|| - d) * sqrt_inf, (1,)."""
    diff = pose_a[:3] - pose_b[:3]
    dist_est = torch.sqrt(torch.sum(diff * diff, -1, keepdim=True) + 1e-12)
    return (dist_est - distance) * sqrt_inf


def range_residual_antenna(pose_a, pose_b, distance, sqrt_inf, ant_a, ant_b):
    """Range residual between the antenna points t + R(yaw) ant, (1,)."""
    pa = pose_a[:3] + geo.yaw_rotate(pose_a[3], ant_a)
    pb = pose_b[:3] + geo.yaw_rotate(pose_b[3], ant_b)
    diff = pa - pb
    dist_est = torch.sqrt(torch.sum(diff * diff, -1, keepdim=True) + 1e-12)
    return (dist_est - distance) * sqrt_inf


def relpose_residual(pose_a, pose_b, dpose_meas, sqrt_info):
    """sqrt_info @ wrap(meas - a^-1 b), (4,)."""
    err = dpose_meas - geo.delta_pose(pose_a, pose_b)
    err = torch.cat([err[:3], geo.normalize_angle(err[3:])])
    return sqrt_info @ err


def detection_residual(pose_a, pose_b, direction, tangent_base, inv_dep,
                       dpose_a, dpose_b, enable_depth, sphere_std: float,
                       inv_dep_std: float):
    """Whitened bearing (+ inverse-depth) residual, (3,).

    rel = translation of (a dpose_a)^-1 (b dpose_b); the bearing error is
    the tangent-plane projection of unit(rel) - direction; the third
    component (inv_dep - 1/||rel||) is multiplied by ``enable_depth``.
    """
    pa = geo.pose_mul(pose_a, dpose_a)
    pb = geo.pose_mul(pose_b, dpose_b)
    rel = geo.delta_pose_trans(pa, pb)
    norm = torch.sqrt(torch.sum(rel * rel, -1, keepdim=True) + 1e-12)
    unit = rel / norm
    bearing = (tangent_base @ (unit - direction)) / sphere_std
    depth_err = (inv_dep - 1.0 / norm) / inv_dep_std
    depth_err = depth_err * enable_depth.to(bearing.dtype)
    return torch.cat([bearing, depth_err])


class FactorEval(NamedTuple):
    residual: torch.Tensor  # (K, dim)
    jac_a: torch.Tensor     # (K, dim, 4)
    jac_b: torch.Tensor     # (K, dim, 4)


def _with_jac(fn):
    """fn(pose_a, pose_b, *consts) -> FactorEval with its pose Jacobians."""
    jac = jacfwd(fn, argnums=(0, 1))

    def eval_one(pose_a, pose_b, *consts):
        ja, jb = jac(pose_a, pose_b, *consts)
        return FactorEval(fn(pose_a, pose_b, *consts), ja, jb)

    return eval_one


range_eval = vmap(_with_jac(range_residual))
range_eval_antenna = vmap(_with_jac(range_residual_antenna))
relpose_eval = vmap(_with_jac(relpose_residual))


def make_detection_eval(sphere_std: float, inv_dep_std: float):
    def det_fn(pose_a, pose_b, direction, tangent_base, inv_dep, dpose_a,
               dpose_b, enable_depth):
        return detection_residual(
            pose_a, pose_b, direction, tangent_base, inv_dep, dpose_a,
            dpose_b, enable_depth, sphere_std, inv_dep_std)

    return vmap(_with_jac(det_fn))


def huber_weight(residual: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS sqrt-weight for Ceres HuberLoss(delta) on whitened residual rows:
    1 if ||r|| <= delta else delta/||r||."""
    norm = torch.sqrt(torch.sum(residual * residual, dim=-1))
    return torch.where(norm <= delta, 1.0,
                       delta / torch.clamp_min(norm, 1e-12))


def huber_rho(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """Ceres HuberLoss rho(s): s if s<=delta^2 else 2*delta*sqrt(s)-delta^2."""
    d2 = delta * delta
    return torch.where(
        sq_norm <= d2, sq_norm,
        2.0 * delta * torch.sqrt(torch.clamp_min(sq_norm, 0.0)) - d2)
