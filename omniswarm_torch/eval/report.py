"""Offline accuracy reports — the local_plot.py equivalent.

A copy of ``omniswarm_tpu/eval/report.py`` over the port's metrics. It
produces the original system's evaluation artifacts
(``swarm_localization/scripts/local_plot.py``): per-drone fused vs
ground-truth trajectories and errors (plot_fused_err :486-560), relative
pose errors between drone pairs (plot_relative_pose_err :331-484), UWB
range error statistics (plot_distance_err :243-330) — as matplotlib
figures saved to a directory plus a machine-readable JSON summary.
matplotlib is optional: without it only the JSON is written.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from omniswarm_torch.eval import metrics


def evaluate(est: np.ndarray, gt: np.ndarray,
             ranges: Optional[np.ndarray] = None,
             range_valid: Optional[np.ndarray] = None) -> Dict:
    """Numeric summary. est/gt: (F, D, 4)."""
    F, D = est.shape[:2]
    per_drone = {}
    for d in range(D):
        aligned = metrics.align_first_pose(est[:, d], gt[:, d])
        per_drone[d] = {
            "ate_pos": metrics.ate_pos(aligned[:, :3], gt[:, d, :3]),
            "yaw_rmse": metrics.yaw_rmse(aligned[:, 3], gt[:, d, 3]),
        }
    pairs = {}
    for a in range(D):
        for b in range(D):
            if a != b:
                pairs[f"{a}->{b}"] = metrics.relative_ate(est, gt, a, b)
    out = {
        "per_drone": per_drone,
        "relative_ate_pairs": pairs,
        "mean_relative_ate": metrics.mean_relative_ate(est, gt),
    }
    if ranges is not None:
        true_d = np.linalg.norm(
            gt[:, :, None, :3] - gt[:, None, :, :3], axis=-1)
        err = ranges - true_d
        if range_valid is not None:
            err = err[range_valid]
        out["range_error"] = {
            "mean": float(np.mean(err)),
            "std": float(np.std(err)),
            "rmse": float(np.sqrt(np.mean(err ** 2))),
        }
    return out


def write_report(out_dir: str, est: np.ndarray, gt: np.ndarray,
                 times: Optional[np.ndarray] = None,
                 ranges: Optional[np.ndarray] = None,
                 range_valid: Optional[np.ndarray] = None,
                 vio: Optional[np.ndarray] = None) -> Dict:
    """Write summary.json + trajectory/error figures; returns the summary."""
    os.makedirs(out_dir, exist_ok=True)
    summary = evaluate(est, gt, ranges, range_valid)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return summary

    F, D = est.shape[:2]
    t = times if times is not None else np.arange(F)

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for d in range(D):
        axes[0].plot(gt[:, d, 0], gt[:, d, 1], "--", alpha=0.6,
                     label=f"gt {d}")
        axes[0].plot(est[:, d, 0], est[:, d, 1], "-", label=f"est {d}")
    axes[0].set_title("XY trajectories")
    axes[0].legend(fontsize=6)
    axes[0].axis("equal")
    for d in range(D):
        aligned = metrics.align_first_pose(est[:, d], gt[:, d])
        err = np.linalg.norm(aligned[:, :3] - gt[:, d, :3], axis=1)
        axes[1].plot(t, err, label=f"drone {d}")
        if vio is not None:
            verr = np.linalg.norm(vio[:, d, :3] - gt[:, d, :3], axis=1)
            axes[1].plot(t, verr, ":", alpha=0.5)
    axes[1].set_title("position error (m); dotted = raw VIO")
    axes[1].legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "fused_err.png"), dpi=110)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 5))
    for a in range(D):
        for b in range(a + 1, D):
            rel_est = est[:, b, :3] - est[:, a, :3]
            rel_gt = gt[:, b, :3] - gt[:, a, :3]
            ax.plot(t, np.linalg.norm(rel_est - rel_gt, axis=1),
                    label=f"{a}-{b}")
    ax.set_title("relative position error between pairs (m)")
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "relative_err.png"), dpi=110)
    plt.close(fig)
    return summary
