"""Measurement-level swarm simulator (numpy, host side).

A copy of ``omniswarm_tpu/sim/simulator.py`` (:23-237) so that the port needs
no JAX package at run time: ground-truth perturbed-circle trajectories,
drift-integrated noisy VIO, noisy UWB ranges, proximity-based loop edges and
visibility-checked drone detections, all from ``numpy.random.default_rng``.
The same ``SimParams`` give bit-identical ``SimData`` in both packages
(tests/test_torch_sim_geometry.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


def wrap(a):
    return a - 2 * np.pi * np.floor((a + np.pi) / (2 * np.pi))


def delta_pose_np(a, b):
    """a^-1 ∘ b for [x,y,z,yaw] arrays (...,4)."""
    c, s = np.cos(-a[..., 3]), np.sin(-a[..., 3])
    d = b[..., :3] - a[..., :3]
    out = np.empty(np.broadcast(a, b).shape[:-1] + (4,))
    out[..., 0] = c * d[..., 0] - s * d[..., 1]
    out[..., 1] = s * d[..., 0] + c * d[..., 1]
    out[..., 2] = d[..., 2]
    out[..., 3] = wrap(b[..., 3] - a[..., 3])
    return out


def invert_pose_np(p):
    """Inverse of a 4-DoF pose: invert_pose_np(p) ∘ p = identity."""
    return delta_pose_np(p, np.zeros(np.shape(p)))


def pose_mul_np(a, b):
    c, s = np.cos(a[..., 3]), np.sin(a[..., 3])
    out = np.empty(np.broadcast(a, b).shape[:-1] + (4,))
    out[..., 0] = a[..., 0] + c * b[..., 0] - s * b[..., 1]
    out[..., 1] = a[..., 1] + s * b[..., 0] + c * b[..., 1]
    out[..., 2] = a[..., 2] + b[..., 2]
    out[..., 3] = wrap(a[..., 3] + b[..., 3])
    return out


@dataclass
class SimParams:
    """Noise/config knobs mirroring simulator.launch:27-95."""

    num_drones: int = 5
    num_frames: int = 50
    dt: float = 1.0                    # keyframe period (s)
    # Trajectory shape
    radius_range: Tuple[float, float] = (2.0, 5.0)
    omega_range: Tuple[float, float] = (0.3, 0.7)
    z_range: Tuple[float, float] = (0.5, 2.5)
    perturb_xyz: float = 0.3           # per-axis GT sinusoid perturbation
    # Noise models (simulator.launch sets vo/distance noise covariances)
    vio_pos_drift_per_step: float = 0.01
    vio_yaw_drift_per_step: float = 0.002
    uwb_noise_std: float = 0.1
    uwb_bias: float = 0.0
    uwb_scale: float = 1.0             # measured = bias + scale*true + noise
    # Loop generation (fake place recognition)
    loop_every: int = 5                # attempt loops every k frames
    loop_max_distance: float = 3.0     # proximity gate (faiss L2 emulation)
    loop_pos_std: float = 0.05
    loop_yaw_std: float = 0.02
    loop_outlier_rate: float = 0.0
    loop_outlier_mag: float = 5.0
    # Detection generation
    det_max_distance: float = 6.0
    det_fov_cos: float = -1.0          # omnidirectional by default
    det_bearing_std: float = 0.01
    det_inv_dep_std: float = 0.03
    det_rate: float = 1.0              # probability a visible pair detects
    seed: int = 0


@dataclass
class LoopMeas:
    frame_a: int
    drone_a: int
    frame_b: int
    drone_b: int
    dpose: np.ndarray          # (4,) measured relative pose (b in a's frame)
    pos_std: float = 0.05
    yaw_std: float = 0.02
    is_outlier: bool = False   # ground-truth label for PCM tests


@dataclass
class DetMeas:
    frame: int
    drone_a: int
    drone_b: int
    direction: np.ndarray      # (3,) unit bearing in a's yaw-frame
    inv_dep: float
    anonymous_id: Optional[int] = None


@dataclass
class SimData:
    params: SimParams
    times: np.ndarray          # (F,)
    gt: np.ndarray             # (F, D, 4) ground truth keyframe poses
    vio: np.ndarray            # (F, D, 4) drifting VIO poses (per-drone frame)
    ranges: np.ndarray         # (F, D, D) noisy UWB distances (sym, diag=0)
    range_valid: np.ndarray    # (F, D, D) bool
    loops: List[LoopMeas] = field(default_factory=list)
    detections: List[DetMeas] = field(default_factory=list)


def proximity_loops(gt, rng, *, loop_every: int = 5,
                    loop_max_distance: float = 2.0,
                    loop_outlier_rate: float = 0.0,
                    loop_outlier_mag: float = 3.0,
                    loop_pos_std: float = 0.05,
                    loop_yaw_std: float = 0.02) -> List[LoopMeas]:
    """Proximity-gated fake place recognition over (F, D, 4) GT poses.

    swarm_local_sim.cpp:474-529 queries a faiss L2 index of GT positions
    with a MATCH_INDEX_DIST recency guard; emulated directly. Reused by
    sim.generate AND the real-flight-log replay tier (io/flightlog.py) —
    the reference's bag replay carries recorded loop edges; CSV logs don't,
    so the replay synthesizes them the same way its simulator does.
    """
    F, D = gt.shape[:2]
    pos = np.asarray(gt)[..., :3]
    loops: List[LoopMeas] = []
    for k in range(0, F, loop_every):
        for da in range(D):
            # candidate: any earlier keyframe of any drone within gate, the
            # nearest, the first in (kb, db) order among equals. All the
            # distances at once pick the near-nearest pairs; the same
            # per-pair norm as the reference's scan decides among those
            # alone, in its order, so the choice is the reference's.
            near = np.linalg.norm(pos[k, da] - pos[:k + 1], axis=-1)
            near[max(0, k - 2):, da] = np.inf     # MATCH_INDEX_DIST
            lo = near.min()
            best = None
            for kb, db in np.argwhere(near <= lo * (1 + 1e-6) + 1e-9):
                dist = np.linalg.norm(gt[k, da, :3] - gt[kb, db, :3])
                if dist < loop_max_distance:
                    if best is None or dist < best[0]:
                        best = (dist, int(kb), int(db))
            if best is None:
                continue
            _, kb, db = best
            dp = delta_pose_np(gt[k, da], gt[kb, db])
            is_outlier = rng.uniform() < loop_outlier_rate
            if is_outlier:
                dp = dp + rng.normal(0, loop_outlier_mag, size=4)
            else:
                dp[:3] += rng.normal(0, loop_pos_std, size=3)
                dp[3] = wrap(dp[3] + rng.normal(0, loop_yaw_std))
            loops.append(LoopMeas(k, da, kb, db, dp,
                                  loop_pos_std, loop_yaw_std, is_outlier))
    return loops


def generate(params: SimParams) -> SimData:
    rng = np.random.default_rng(params.seed)
    F, D = params.num_frames, params.num_drones
    t = np.arange(F) * params.dt

    # --- ground truth: perturbed circles (swarm_local_sim.cpp:532-586) ----
    gt = np.zeros((F, D, 4))
    for d in range(D):
        r = rng.uniform(*params.radius_range)
        w = rng.uniform(*params.omega_range) * (1 if d % 2 == 0 else -1)
        phase = rng.uniform(0, 2 * np.pi)
        cx, cy = rng.uniform(-3, 3, size=2)
        z0 = rng.uniform(*params.z_range)
        ang = w * t + phase
        gt[:, d, 0] = cx + r * np.cos(ang) + params.perturb_xyz * np.sin(1.7 * t + d)
        gt[:, d, 1] = cy + r * np.sin(ang) + params.perturb_xyz * np.cos(1.3 * t + d)
        gt[:, d, 2] = z0 + params.perturb_xyz * 0.5 * np.sin(0.9 * t + 2 * d)
        gt[:, d, 3] = wrap(ang + np.pi / 2)

    # --- drifting VIO: integrate GT deltas + noise, in each drone's own
    # frame anchored at its first GT pose (the reference VIO starts at the
    # drone's local origin; we keep the first pose equal to GT for easy
    # comparison — a constant offset is unobservable anyway). ----------------
    vio = np.zeros_like(gt)
    vio[0] = gt[0]
    for k in range(1, F):
        d_gt = delta_pose_np(gt[k - 1], gt[k])
        noise = np.concatenate(
            [rng.normal(0, params.vio_pos_drift_per_step, size=(D, 3)),
             rng.normal(0, params.vio_yaw_drift_per_step, size=(D, 1))], axis=1)
        vio[k] = pose_mul_np(vio[k - 1], d_gt + noise)

    # --- UWB ranges (noisy, symmetric) ------------------------------------
    diff = gt[:, :, None, :3] - gt[:, None, :, :3]
    true_d = np.linalg.norm(diff, axis=-1)
    noise = rng.normal(0, params.uwb_noise_std, size=true_d.shape)
    noise = 0.5 * (noise + np.swapaxes(noise, 1, 2))
    ranges = np.maximum(
        params.uwb_scale * true_d + noise + params.uwb_bias, 0.0)
    range_valid = np.ones((F, D, D), bool)
    np.einsum("fdd->fd", ranges)[:] = 0.0
    np.einsum("fdd->fd", range_valid)[:] = False

    loops = proximity_loops(
        gt, rng, loop_every=params.loop_every,
        loop_max_distance=params.loop_max_distance,
        loop_outlier_rate=params.loop_outlier_rate,
        loop_outlier_mag=params.loop_outlier_mag,
        loop_pos_std=params.loop_pos_std, loop_yaw_std=params.loop_yaw_std)

    # --- detections: visibility-checked bearings --------------------------
    dets: List[DetMeas] = []
    for k in range(F):
        for da in range(D):
            for db in range(D):
                if da == db:
                    continue
                rel = delta_pose_np(gt[k, da], gt[k, db])[:3]
                dist = np.linalg.norm(rel)
                if dist > params.det_max_distance or dist < 1e-3:
                    continue
                if rng.uniform() > params.det_rate:
                    continue
                unit = rel / dist
                if unit[0] < params.det_fov_cos:  # crude forward-FOV gate
                    continue
                noisy = unit + rng.normal(0, params.det_bearing_std, size=3)
                noisy /= np.linalg.norm(noisy)
                inv_dep = 1.0 / dist + rng.normal(0, params.det_inv_dep_std)
                dets.append(DetMeas(k, da, db, noisy, float(inv_dep)))

    return SimData(params=params, times=t, gt=gt, vio=vio, ranges=ranges,
                   range_valid=range_valid, loops=loops, detections=dets)
