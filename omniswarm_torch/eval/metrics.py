"""Accuracy metrics (numpy): a copy of ``omniswarm_tpu/eval/metrics.py``.

- ``rmse``, ``ate_pos`` (RMSE of the 3-D error norm), ``yaw_rmse``
- ``relative_ate`` / ``mean_relative_ate``: relative-pose ATE between drone
  pairs, the headline accuracy metric of the flagship solve
- ``align_first_pose`` / ``align_yaw_translation``: trajectory alignment
"""
from __future__ import annotations

import numpy as np


def wrap(a):
    return a - 2 * np.pi * np.floor((a + np.pi) / (2 * np.pi))


def rmse(err: np.ndarray, axis=None) -> np.ndarray:
    return np.sqrt(np.mean(np.square(err), axis=axis))


def ate_pos(est_pos: np.ndarray, gt_pos: np.ndarray) -> float:
    """RMSE of the 3-D position error norm. Shapes (..., 3)."""
    err = np.linalg.norm(est_pos - gt_pos, axis=-1)
    return float(np.sqrt(np.mean(np.square(err))))


def yaw_rmse(est_yaw: np.ndarray, gt_yaw: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(wrap(est_yaw - gt_yaw)))))


def relative_ate(est: np.ndarray, gt: np.ndarray, drone_a: int, drone_b: int) -> float:
    """ATE of the relative position of drone_b in drone_a's yaw-frame.

    est/gt: (F, D, 4). This is the metric that matters for a decentralized
    relative-localization system (reference plot_relative_pose_err).
    """
    def rel(traj):
        a, b = traj[:, drone_a], traj[:, drone_b]
        c, s = np.cos(-a[:, 3]), np.sin(-a[:, 3])
        d = b[:, :3] - a[:, :3]
        return np.stack([c * d[:, 0] - s * d[:, 1],
                         s * d[:, 0] + c * d[:, 1],
                         d[:, 2]], axis=1)

    return ate_pos(rel(est), rel(gt))


def mean_relative_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """Average relative ATE over all ordered drone pairs."""
    D = est.shape[1]
    vals = [relative_ate(est, gt, a, b)
            for a in range(D) for b in range(D) if a != b]
    return float(np.mean(vals))


def align_first_pose(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Left-multiply est by the 4-DoF offset making est[0] == gt[0].

    est/gt: (F, 4) single trajectory.
    """
    # offset = gt0 ∘ est0^-1
    e0, g0 = est[0], gt[0]
    dyaw = wrap(g0[3] - e0[3])
    c, s = np.cos(dyaw), np.sin(dyaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    out = est.copy()
    out[:, :3] = (est[:, :3] - e0[:3]) @ R.T + g0[:3]
    out[:, 3] = wrap(est[:, 3] + dyaw)
    return out


def align_yaw_translation(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Best-fit 4-DoF (yaw + translation) alignment of est onto gt.

    Closed-form least squares over the xy plane (z gets its own offset);
    the 4-DoF analog of Umeyama used when grading absolute ATE.
    """
    e_c = est[:, :2] - est[:, :2].mean(0)
    g_c = gt[:, :2] - gt[:, :2].mean(0)
    num = np.sum(e_c[:, 0] * g_c[:, 1] - e_c[:, 1] * g_c[:, 0])
    den = np.sum(e_c[:, 0] * g_c[:, 0] + e_c[:, 1] * g_c[:, 1])
    dyaw = np.arctan2(num, den)
    c, s = np.cos(dyaw), np.sin(dyaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    out = est.copy()
    rot = est[:, :3] @ R.T
    out[:, :3] = rot + (gt[:, :3].mean(0) - rot.mean(0))
    out[:, 3] = wrap(est[:, 3] + dyaw)
    return out
