"""PCM outlier-rejection forensics — the debugging_pcm equivalent.

A copy of ``omniswarm_tpu/eval/pcm_debug.py`` over the port's
``robust.pcm.PCMResult`` (``smd`` needs ``pcm_filter(...,
return_smd=True)``). The original system debugs mis-rejected loops with
per-pair consistency plots and error logs (``local_plot.py``
``debugging_pcm``, fed by the pcm logs of swarm_outlier_rejection.cpp:16-21).
This module produces the same forensics from a PCMResult: per-drone-pair
consistency-matrix heatmaps with the selected clique highlighted,
per-loop acceptance records, and — when ground truth is available — each
loop's true measurement error, so "rejected but correct" / "accepted but
wrong" cases are visible at a glance.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


def pcm_debug_records(loops, result, gt: Optional[np.ndarray] = None):
    """Per-loop forensic records.

    loops: robust.pcm.LoopSet; result: robust.pcm.PCMResult;
    gt: optional (F, D, 4) ground-truth grid for true-error computation.
    """
    L = loops.frame_a.shape[0]
    recs = []
    for i in range(L):
        rec = {
            "index": i,
            "pair": (int(loops.drone_a[i]), int(loops.drone_b[i])),
            "frame_a": int(loops.frame_a[i]),
            "frame_b": int(loops.frame_b[i]),
            "accepted": bool(result.good_mask[i]),
            "min_smd": float(np.min(np.delete(result.smd[i], i)))
            if L > 1 else 0.0,
        }
        if gt is not None:
            from omniswarm_torch.sim.simulator import delta_pose_np

            pa = np.asarray(gt[loops.frame_a[i], loops.drone_a[i]])
            pb = np.asarray(gt[loops.frame_b[i], loops.drone_b[i]])
            true_dp = delta_pose_np(pa[None], pb[None])[0]
            err = np.asarray(loops.dpose[i]) - true_dp
            err[3] = (err[3] + np.pi) % (2 * np.pi) - np.pi
            rec["true_pos_err"] = float(np.linalg.norm(err[:3]))
            rec["true_yaw_err"] = float(abs(err[3]))
        recs.append(rec)
    return recs


def write_pcm_debug(out_dir: str, loops, result,
                    gt: Optional[np.ndarray] = None,
                    pcm_thres: float = 0.6) -> Dict:
    """Write heatmaps + JSON forensics; returns the summary dict."""
    os.makedirs(out_dir, exist_ok=True)
    recs = pcm_debug_records(loops, result, gt)

    summary = {
        "n_loops": len(recs),
        "n_accepted": int(np.sum(result.good_mask)),
        "pcm_thres": pcm_thres,
        "loops": recs,
    }
    if gt is not None and recs:
        acc = [r for r in recs if r["accepted"]]
        rej = [r for r in recs if not r["accepted"]]
        if acc:
            summary["accepted_pos_err_mean"] = float(
                np.mean([r["true_pos_err"] for r in acc]))
        if rej:
            summary["rejected_pos_err_mean"] = float(
                np.mean([r["true_pos_err"] for r in rej]))
    with open(os.path.join(out_dir, "pcm_debug.json"), "w") as f:
        json.dump(summary, f, indent=1)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:                      # pragma: no cover
        return summary

    pairs = sorted({r["pair"] for r in recs})
    for pair in pairs:
        idx = np.array([r["index"] for r in recs if r["pair"] == pair])
        if idx.size < 2:
            continue
        sub = result.smd[np.ix_(idx, idx)]
        sel = np.array([bool(result.good_mask[i]) for i in idx])
        fig, ax = plt.subplots(figsize=(5, 4.4))
        im = ax.imshow(np.minimum(sub, 4 * pcm_thres), cmap="viridis")
        fig.colorbar(im, ax=ax, label="pairwise Mahalanobis")
        for k in np.flatnonzero(sel):
            ax.add_patch(plt.Rectangle((k - 0.5, k - 0.5), 1, 1,
                                       fill=False, edgecolor="w", lw=1.5))
        ax.set_title(f"PCM consistency, pair {pair[0]}-{pair[1]} "
                     f"({sel.sum()}/{idx.size} inliers)")
        ax.set_xlabel("loop #")
        ax.set_ylabel("loop #")
        fig.tight_layout()
        fig.savefig(os.path.join(
            out_dir, f"pcm_pair_{pair[0]}_{pair[1]}.png"), dpi=110)
        plt.close(fig)
    return summary
