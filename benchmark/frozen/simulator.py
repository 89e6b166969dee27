"""The swarm's flight (numpy, host side): the benchmark's frozen copy of
the first part of the port's measurement-level simulator.

Copied unchanged in its arithmetic from the port's ``sim/simulator.py``
(ground-truth perturbed-circle trajectories and drift-integrated noisy
VIO, the first draws of ``numpy.random.default_rng(seed)``), so that a
change to the program cannot change the poses the benchmark renders.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

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
    """The trajectory and VIO knobs of the port's simulator (its
    simulator.launch:27-95 mirror); its range, loop and detection knobs
    are left out with the draws they drive."""

    num_drones: int = 5
    num_frames: int = 50
    dt: float = 1.0                    # keyframe period (s)
    # Trajectory shape
    radius_range: Tuple[float, float] = (2.0, 5.0)
    omega_range: Tuple[float, float] = (0.3, 0.7)
    z_range: Tuple[float, float] = (0.5, 2.5)
    perturb_xyz: float = 0.3           # per-axis GT sinusoid perturbation
    # VIO noise
    vio_pos_drift_per_step: float = 0.01
    vio_yaw_drift_per_step: float = 0.002
    seed: int = 0


class Flight(NamedTuple):
    gt: np.ndarray                     # (F, D, 4) ground-truth poses
    vio: np.ndarray                    # (F, D, 4) drifting VIO


def generate(params: SimParams) -> Flight:
    """The swarm's flight from ``params.seed``: the same ground truth and
    VIO as the port's simulator draws first."""
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

    return Flight(gt=gt, vio=vio)
