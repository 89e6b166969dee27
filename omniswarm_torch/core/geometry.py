"""4-DoF pose geometry as broadcastable torch operations.

Counterpart of ``omniswarm_tpu/core/geometry.py``: the pose algebra
(:33-93), quaternions (:100-143), the numpy SE(3) helpers (:156-230), the
tangent basis (numpy :232, torch :256) and the consistency metrics
(:276-290). Poses are tensors of shape ``(..., 4)`` = ``[x, y, z, yaw]``,
quaternions ``(..., 4)`` in ``(w, x, y, z)`` order, points ``(..., 3)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi)."""
    # floor has a zero derivative, so its argument is detached: under
    # torch.func.jacfwd a 0-d dual times a Python float promotes the
    # tangent to float64
    return theta - TWO_PI * torch.floor((theta.detach() + math.pi) / TWO_PI)


def yaw_rotate(yaw: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) about +z by yaw. vec: (..., 3), yaw: (...)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = c * vec[..., 0] - s * vec[..., 1]
    y = s * vec[..., 0] + c * vec[..., 1]
    z = torch.broadcast_to(vec[..., 2], x.shape)
    return torch.stack([x, y, z], dim=-1)


def pose_position(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3]


def pose_yaw(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., 3]


def make_pose(position: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(position.shape[:-1], yaw.shape)
    position = torch.broadcast_to(position, shape + (3,))
    yaw = torch.broadcast_to(yaw, shape)
    return torch.cat([position, yaw[..., None]], dim=-1)


def pose_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose poses: a ∘ b (apply b in a's frame)."""
    t = yaw_rotate(a[..., 3], b[..., :3]) + a[..., :3]
    yaw = normalize_angle(a[..., 3] + b[..., 3])
    return make_pose(t, yaw)


def pose_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse pose: pose_mul(a, pose_inv(a)) == identity."""
    yaw = -a[..., 3]
    t = -yaw_rotate(yaw, a[..., :3])
    return make_pose(t, normalize_angle(yaw))


def delta_pose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative pose a^-1 ∘ b as a 4-vector with wrapped yaw."""
    dt = yaw_rotate(-a[..., 3], b[..., :3] - a[..., :3])
    dyaw = normalize_angle(b[..., 3] - a[..., 3])
    return make_pose(dt, dyaw)


def delta_pose_trans(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Translation-only relative position of b in a's frame, (..., 3)."""
    return yaw_rotate(-a[..., 3], b[..., :3] - a[..., :3])


def transform_point(pose: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Map point from pose's body frame into the world frame."""
    return yaw_rotate(pose[..., 3], point) + pose[..., :3]


def inverse_transform_point(pose: torch.Tensor,
                            point: torch.Tensor) -> torch.Tensor:
    """Map a world-frame point into pose's body frame."""
    return yaw_rotate(-pose[..., 3], point - pose[..., :3])


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z), for ingesting 6-DoF VIO odometry.
# ---------------------------------------------------------------------------

def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q."""
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    half = 0.5 * yaw
    z = torch.zeros_like(half)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Extract yaw (z of ZYX euler) from a unit quaternion."""
    w, x, y, z = (q[..., i] for i in range(4))
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def pose6_to_pose4(position: torch.Tensor, quat: torch.Tensor
                   ) -> torch.Tensor:
    """Project a 6-DoF pose (position + quaternion) to [x, y, z, yaw]."""
    return make_pose(position, yaw_from_quat(quat))


def tangent_base_from_unit(unit_dir: torch.Tensor) -> torch.Tensor:
    """2x3 orthonormal basis of the tangent plane of a unit bearing vector
    (rows orthogonal to ``unit_dir``; helper axis z unless |dir_z| > 0.99).
    Shape (..., 3) -> (..., 2, 3)."""
    near_z = torch.abs(unit_dir[..., 2]) > 0.99
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=unit_dir.dtype,
                      device=unit_dir.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=unit_dir.dtype,
                      device=unit_dir.device)
    helper = torch.where(near_z[..., None], ex, ez)
    proj = torch.sum(helper * unit_dir, dim=-1, keepdim=True)
    b1 = helper - unit_dir * proj
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(unit_dir, b1)
    return torch.stack([b1, b2], dim=-2)


def squared_mahalanobis(err: torch.Tensor, cov_inv: torch.Tensor
                        ) -> torch.Tensor:
    """err^T Σ^-1 err over the last axis; cov_inv (..., D, D)."""
    return torch.einsum("...i,...ij,...j->...", err, cov_inv, err)


def pose_error_4d(est: torch.Tensor, meas: torch.Tensor,
                  sqrt_info: torch.Tensor) -> torch.Tensor:
    """Whitened 4-vector pose error sqrt_info @ wrap(meas - est)
    (factors.hpp:52-61: measurement minus estimate, yaw wrapped)."""
    err = meas - est
    err = torch.cat([err[..., :3], normalize_angle(err[..., 3:])], dim=-1)
    return torch.einsum("...ij,...j->...i", sqrt_info, err)


def tangent_base_from_unit_np(unit_dir):
    """2x3 orthonormal tangent basis of unit bearing(s), numpy (host side).

    Shapes (..., 3) -> (..., 2, 3): helper axis z unless |dir_z| > 0.99.
    """
    unit_dir = np.asarray(unit_dir, np.float32)
    near_z = np.abs(unit_dir[..., 2]) > 0.99
    helper = np.where(
        near_z[..., None],
        np.asarray([1.0, 0.0, 0.0], np.float32),
        np.asarray([0.0, 0.0, 1.0], np.float32))
    proj = np.sum(helper * unit_dir, axis=-1, keepdims=True)
    b1 = helper - unit_dir * proj
    b1 = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = np.cross(unit_dir, b1)
    return np.stack([b1, b2], axis=-2)


# ---------------------------------------------------------------------------
# Numpy SE(3) helpers for host-side 6-DoF loop re-anchoring (the reference's
# core/geometry.py:156-230): full-attitude VIO poses are composed before the
# 4-DoF flatten. Pose6 layout: (..., 7) = [x, y, z, qw, qx, qy, qz].
# ---------------------------------------------------------------------------

def quat_mul_np(q1, q2):
    w1, x1, y1, z1 = (q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3])
    w2, x2, y2, z2 = (q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3])
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_conj_np(q):
    return q * np.asarray([1.0, -1.0, -1.0, -1.0])


def quat_rotate_np(q, v):
    w, xyz = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def quat_from_rpy_np(roll, pitch, yaw):
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy], -1)


def yaw_from_quat_np(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def se3_mul_np(a, b):
    """Compose (..., 7) pose6: a ∘ b."""
    t = a[..., :3] + quat_rotate_np(a[..., 3:], b[..., :3])
    q = quat_mul_np(a[..., 3:], b[..., 3:])
    return np.concatenate([t, q], -1)


def se3_inv_np(a):
    qc = quat_conj_np(a[..., 3:])
    return np.concatenate([-quat_rotate_np(qc, a[..., :3]), qc], -1)


def se3_delta_np(a, b):
    """a^-1 ∘ b for (..., 7) pose6."""
    return se3_mul_np(se3_inv_np(a), b)


def se3_to_pose4_np(a):
    """Flatten pose6 to [x, y, z, yaw]."""
    return np.concatenate([a[..., :3], yaw_from_quat_np(a[..., 3:])[..., None]],
                          -1)


def pose4_to_se3_np(p):
    p = np.asarray(p, float)
    return np.concatenate(
        [p[..., :3], quat_from_rpy_np(
            np.zeros_like(p[..., 3]), np.zeros_like(p[..., 3]),
            p[..., 3])], -1)
