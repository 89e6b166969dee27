"""Offline sensor-calibration estimators (reference analysis-script parity).

A copy of ``omniswarm_tpu/eval/calibration.py`` over the port's metrics
and ``config.NodeConfig``.

Mirrors the reference's rosbag forensics tooling:

- ``fit_uwb_calibration`` / ``uwb_pair_calibrations`` reproduce
  swarm_localization/scripts/local_plot.py:243-330 (plot_distance_err):
  a degree-1 fit gt ~= z0*raw + z1 per drone pair, raw-vs-fitted RMSE, and
  Gaussian residual stats after a 1 m outlier filter. The result is
  expressed directly in the NodeConfig convention
  (measured = bias + scale * true — swarm_nodes5.yaml / Node::to_real_distance,
  swarm_localization_node.cpp:88) so it plugs into SwarmConfig unchanged.
- ``odometry_covariance_per_meter`` reproduces
  swarm_localization/scripts/utils.py:105-156: windowed relative-pose VO
  error (expressed in the window-start yaw frame) accumulated as
  err err^T / segment_length, outlier-gated, averaged over one or more
  window path lengths. Feeds the solver's per-meter VIO drift covariance
  (vo_cov_pos_per_meter / vo_cov_yaw_per_meter).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from omniswarm_torch.eval.metrics import wrap


@dataclass
class UWBCalibration:
    """Per-pair UWB range calibration in the NodeConfig convention."""

    scale: float          # measured = bias + scale * true
    bias: float
    rmse_raw: float       # RMSE of raw-vs-GT distance
    mu_raw: float         # Gaussian fit of raw error (gt - raw)
    std_raw: float
    mu_calibrated: float  # Gaussian fit of post-fit residual (outlier-gated)
    std_calibrated: float
    num_samples: int
    num_outliers: int     # samples dropped by the residual gate


def fit_uwb_calibration(raw: np.ndarray, gt: np.ndarray, *,
                        outlier_thres: float = 1.0) -> UWBCalibration:
    """Fit one pair's range calibration from raw UWB vs ground-truth distance.

    Follows local_plot.py:294-304: np.polyfit(dis_raw, dis_gt, 1) yields
    true ~= z0*raw + z1; residuals beyond ``outlier_thres`` (1 m in the
    reference) are excluded from the calibrated covariance. Converted to
    the measured = bias + scale*true convention: scale = 1/z0,
    bias = -z1/z0.
    """
    raw = np.asarray(raw, float).ravel()
    gt = np.asarray(gt, float).ravel()
    if raw.size < 2:
        raise ValueError("need at least 2 samples to fit a line")
    z0, z1 = np.polyfit(raw, gt, 1)
    if abs(z0) < 1e-6:
        raise ValueError("degenerate fit: zero scale")
    calibed = z0 * raw + z1
    err_raw = gt - raw
    keep = np.abs(gt - calibed) < outlier_thres
    err_cal = (gt - calibed)[keep]
    if err_cal.size == 0:
        err_cal = gt - calibed
        keep = np.ones_like(gt, bool)
    return UWBCalibration(
        scale=float(1.0 / z0),
        bias=float(-z1 / z0),
        rmse_raw=float(np.sqrt(np.mean(err_raw ** 2))),
        mu_raw=float(np.mean(err_raw)),
        std_raw=float(np.std(err_raw)),
        mu_calibrated=float(np.mean(err_cal)),
        std_calibrated=float(np.std(err_cal)),
        num_samples=int(raw.size),
        num_outliers=int(np.sum(~keep)),
    )


def uwb_pair_calibrations(ranges: np.ndarray, range_valid: np.ndarray,
                          gt_pos: np.ndarray, *,
                          min_samples: int = 8,
                          outlier_thres: float = 1.0,
                          ) -> Dict[Tuple[int, int], UWBCalibration]:
    """Fit every ordered drone pair with enough valid range samples.

    ranges/range_valid: (F, D, D) grids (measured distance a<-b);
    gt_pos: (F, D, 3) ground-truth positions. Returns {(a, b): calibration}
    — (a, b) meaning the range drone ``a`` measured to peer ``b``, matching
    NodeConfig.uwb_bias/uwb_scale keyed by peer id on node ``a``.
    """
    ranges = np.asarray(ranges, float)
    valid = np.asarray(range_valid, bool)
    gt_pos = np.asarray(gt_pos, float)
    D = ranges.shape[1]
    true_d = np.linalg.norm(
        gt_pos[:, :, None, :] - gt_pos[:, None, :, :], axis=-1)
    out: Dict[Tuple[int, int], UWBCalibration] = {}
    for a in range(D):
        for b in range(D):
            if a == b:
                continue
            m = valid[:, a, b]
            if int(m.sum()) < min_samples:
                continue
            out[(a, b)] = fit_uwb_calibration(
                ranges[m, a, b], true_d[m, a, b],
                outlier_thres=outlier_thres)
    return out


def apply_uwb_calibrations(config, calibs: Dict[Tuple[int, int],
                                                UWBCalibration]) -> None:
    """Write fitted per-pair bias/scale into a SwarmConfig's node table.

    Creates NodeConfig entries as needed; the estimator then undoes the
    model on ingest (estimator._calibrate_range)."""
    from omniswarm_torch.config import NodeConfig

    for (a, b), cal in calibs.items():
        node = config.nodes.setdefault(a, NodeConfig(drone_id=a))
        node.uwb_bias[b] = cal.bias
        node.uwb_scale[b] = cal.scale


def fit_uwb_anchor(pos: np.ndarray, raw: np.ndarray) -> Dict[str, object]:
    """Fit a STATIC-anchor UWB model to a single-tag log: measured =
    |pos - anchor| + bias, solved by least squares over (anchor, bias).

    This is what the reference's hover_vicon_uwb.csv records (Vicon pose
    columns + one raw UWB range in the extra trailing column): a hovering
    drone ranging a fixed anchor. Scale is NOT identifiable from a hover
    (the true distance barely changes), so it is pinned at 1 and the
    fit's residual std IS the real sensor noise floor — the number the
    replay campaign uses instead of an ad hoc synthesis constant.
    """
    from scipy.optimize import least_squares

    pos = np.asarray(pos, float)
    raw = np.asarray(raw, float).ravel()

    def resid(x):
        return np.linalg.norm(pos - x[:3], axis=1) + x[3] - raw

    x0 = np.zeros(4)
    x0[:3] = pos.mean(0) + np.array([1.0, 0.0, -1.0])
    fit = least_squares(resid, x0)
    r = fit.fun
    return {
        "anchor": [round(float(v), 4) for v in fit.x[:3]],
        "bias": round(float(fit.x[3]), 4),
        "residual_std": float(np.std(r)),
        "residual_rms": float(np.sqrt(np.mean(r ** 2))),
        "num_samples": int(raw.size),
        "raw_mean": float(raw.mean()),
    }


def _yaw_rotate_inv(yaw: float, v: np.ndarray) -> np.ndarray:
    """Rotate world-frame vector(s) into the yaw frame (R(-yaw) @ v)."""
    c, s = np.cos(yaw), np.sin(yaw)
    v = np.asarray(v, float)
    return np.stack([c * v[..., 0] + s * v[..., 1],
                     -s * v[..., 0] + c * v[..., 1],
                     v[..., 2]], axis=-1)


def odometry_covariance_per_meter(
        pos_vo: np.ndarray, yaw_vo: np.ndarray,
        pos_gt: np.ndarray, yaw_gt: np.ndarray, *,
        rp_lengths: Sequence[float] = (1.0,),
        gt_outlier_thres: float = 1.0,
        step: int = 1) -> Tuple[np.ndarray, float]:
    """Per-meter VO drift covariance from a trajectory with ground truth.

    For each window start i (advancing by ``step``) find the first j whose
    accumulated VO path length reaches ``rp_length``; compare the relative
    pose (in the start pose's yaw frame) of VO vs GT; accumulate
    err err^T / length with an outlier gate |err err^T| <
    gt_outlier_thres * rp_length; average over windows and rp_lengths
    (utils.py:105-156). Returns (pos_cov (3, 3) per meter, yaw_var per
    meter).
    """
    pos_vo = np.asarray(pos_vo, float)
    pos_gt = np.asarray(pos_gt, float)
    yaw_vo = np.asarray(yaw_vo, float).ravel()
    yaw_gt = np.asarray(yaw_gt, float).ravel()
    F = pos_vo.shape[0]
    seg = np.linalg.norm(np.diff(pos_vo, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])

    sum_pos = np.zeros((3, 3))
    sum_yaw = 0.0
    n_rp = 0
    for rp_length in rp_lengths:
        acc_pos = np.zeros((3, 3))
        acc_yaw = 0.0
        c = 0
        i = 0
        while i < F - 1:
            # first j with VO path length >= rp_length
            target = cum[i] + rp_length
            j = int(np.searchsorted(cum, target))
            if j >= F:
                break
            len_ij = cum[j] - cum[i]
            if len_ij > 0.01:
                dpos_vo = _yaw_rotate_inv(yaw_vo[i], pos_vo[j] - pos_vo[i])
                dpos_gt = _yaw_rotate_inv(yaw_gt[i], pos_gt[j] - pos_gt[i])
                dyaw_vo = wrap(yaw_vo[j] - yaw_vo[i])
                dyaw_gt = wrap(yaw_gt[j] - yaw_gt[i])
                err = (dpos_vo - dpos_gt)[:, None]
                sq_pos = (err @ err.T) / len_ij
                sq_yaw = float(wrap(dyaw_vo - dyaw_gt) ** 2) / len_ij
                if np.linalg.norm(sq_pos) < gt_outlier_thres * rp_length:
                    acc_pos += sq_pos
                    acc_yaw += sq_yaw
                    c += 1
            i += step
        if c:
            sum_pos += acc_pos / c
            sum_yaw += acc_yaw / c
            n_rp += 1
    if n_rp == 0:
        return np.zeros((3, 3)), 0.0
    return sum_pos / n_rp, sum_yaw / n_rp


def loop_error_stats(loops: Iterable, gt: np.ndarray) -> Dict[str, float]:
    """Residual forensics of a loop set against ground truth.

    For each loop edge (frame_a, drone_a, frame_b, drone_b, dpose) compute
    the 4-DoF error vs the GT relative pose; report position/yaw RMSE and
    the fraction beyond 3x the median error (the gross-outlier share PCM
    is expected to remove) — the role of local_plot.py plot_loops_error /
    debugging_pcm summaries.
    """
    perrs = []
    yerrs = []
    for lp in loops:
        pa = gt[lp.frame_a, lp.drone_a]
        pb = gt[lp.frame_b, lp.drone_b]
        d = pb[:3] - pa[:3]
        rel = _yaw_rotate_inv(pa[3], d)
        dyaw = wrap(pb[3] - pa[3])
        dp = np.asarray(lp.dpose, float)
        perrs.append(np.linalg.norm(dp[:3] - rel))
        yerrs.append(abs(wrap(dp[3] - dyaw)))
    if not perrs:
        return {"num_loops": 0, "pos_rmse": 0.0, "yaw_rmse": 0.0,
                "gross_outlier_frac": 0.0}
    perrs = np.asarray(perrs)
    yerrs = np.asarray(yerrs)
    med = max(float(np.median(perrs)), 1e-9)
    return {
        "num_loops": int(perrs.size),
        "pos_rmse": float(np.sqrt(np.mean(perrs ** 2))),
        "yaw_rmse": float(np.sqrt(np.mean(yerrs ** 2))),
        "gross_outlier_frac": float(np.mean(perrs > 3.0 * med)),
    }
