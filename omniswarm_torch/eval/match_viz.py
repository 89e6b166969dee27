"""Loop-match debug visualization — side-by-side keypoint match images.

A copy of ``omniswarm_tpu/eval/match_viz.py``. Parity with
loop_detector.cpp:695-785, which draws the matched keypoints of a verified
loop pair onto the two keyframe images (green = PnP inlier, red = rejected
match) and writes a PNG per loop. The renderer is a pure function over
arrays (matplotlib's Agg backend, no cv2), and ``LoopDetector`` exposes an
opt-in hook (``match_viz_dir`` + ``register_image``) that calls it for
every accepted loop.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_match_image(img_a: np.ndarray, kp_a: np.ndarray,
                     img_b: np.ndarray, kp_b: np.ndarray,
                     idx_b: np.ndarray, match_mask: np.ndarray,
                     inliers: Optional[np.ndarray], path: str, *,
                     title: Optional[str] = None) -> str:
    """Write a side-by-side match visualization PNG; returns the path.

    img_a/img_b: (H, W) grayscale in [0, 1] (or uint8). kp_a/kp_b: (K, 2)
    pixel coordinates. idx_b maps each a-keypoint to its matched b-keypoint;
    match_mask selects valid matches; inliers (optional) marks the subset
    the PnP model accepted (drawn green; outliers red).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img_a = np.asarray(img_a, np.float32)
    img_b = np.asarray(img_b, np.float32)
    if img_a.max() > 1.5:
        img_a = img_a / 255.0
    if img_b.max() > 1.5:
        img_b = img_b / 255.0
    ha, wa = img_a.shape[:2]
    hb, wb = img_b.shape[:2]
    H = max(ha, hb)
    canvas = np.full((H, wa + wb), 0.05, np.float32)
    canvas[:ha, :wa] = img_a
    canvas[:hb, wa:] = img_b

    kp_a = np.asarray(kp_a, np.float32)
    kp_b = np.asarray(kp_b, np.float32)
    idx_b = np.asarray(idx_b, int)
    mask = np.asarray(match_mask, bool)
    if inliers is None:
        inliers = np.zeros_like(mask)
    inliers = np.asarray(inliers, bool)

    fig, ax = plt.subplots(figsize=(10, 5 * H / max(wa + wb, 1) * 2))
    ax.imshow(canvas, cmap="gray", vmin=0.0, vmax=1.0)
    ax.scatter(kp_a[:, 0], kp_a[:, 1], s=4, c="#4aa3ff", linewidths=0)
    ax.scatter(kp_b[:, 0] + wa, kp_b[:, 1], s=4, c="#4aa3ff", linewidths=0)
    for i in np.flatnonzero(mask):
        j = idx_b[i] % max(kp_b.shape[0], 1)
        color = "#2ecc40" if inliers[i] else "#ff4136"
        ax.plot([kp_a[i, 0], kp_b[j, 0] + wa], [kp_a[i, 1], kp_b[j, 1]],
                color=color, linewidth=0.6,
                alpha=0.9 if inliers[i] else 0.35)
    n_match, n_inl = int(mask.sum()), int((mask & inliers).sum())
    ax.set_title(title or f"{n_match} matches / {n_inl} inliers",
                 fontsize=9)
    ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
