"""Fixed-capacity, mask-valid drone trajectories as tensors, and the
per-meter drift model.

Counterpart of ``omniswarm_tpu/core/trajectory.py``: the reference's
``Swarm::DroneTrajectory`` (the VIO ego-motion history and the per-meter
drift covariance consumed when loops are re-anchored,
swarm_localization_solver.cpp:1505-1550; ``vo_cov_pos_per_meter`` /
``vo_cov_yaw_per_meter``, swarm_localization_node.cpp:508-509).

A trajectory is a NamedTuple of fixed-shape tensors on one device; ``append``
writes at a ring-buffer cursor and returns a new trajectory (the inputs are
not modified). Timestamps are float32 seconds relative to the session epoch.
The estimator's graph construction stays numpy on the host: it uses
``drift_variances`` and ``path_length_np``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from omniswarm_torch.core import geometry as geo


class Trajectory(NamedTuple):
    """Ring-buffer trajectory. All tensors share leading capacity dim N."""

    ts: torch.Tensor      # (N,) seconds; invalid slots hold +inf
    pose: torch.Tensor    # (N, 4) [x, y, z, yaw]
    cumlen: torch.Tensor  # (N,) cumulative path length at each sample
    cursor: torch.Tensor  # () int64 next write slot
    count: torch.Tensor   # () int64 number of valid samples (<= N)

    @property
    def capacity(self) -> int:
        return self.ts.shape[0]


def make_trajectory(capacity: int, dtype=torch.float32,
                    device="cpu") -> Trajectory:
    return Trajectory(
        ts=torch.full((capacity,), float("inf"), dtype=dtype, device=device),
        pose=torch.zeros((capacity, 4), dtype=dtype, device=device),
        cumlen=torch.zeros((capacity,), dtype=dtype, device=device),
        cursor=torch.zeros((), dtype=torch.int64, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def append(traj: Trajectory, t, pose) -> Trajectory:
    """Append one sample, overwriting the oldest slot when full."""
    n = traj.capacity
    pose = torch.as_tensor(pose, dtype=traj.pose.dtype,
                           device=traj.pose.device)
    t = torch.as_tensor(t, dtype=traj.ts.dtype, device=traj.ts.device)
    slot = traj.cursor % n
    prev_slot = (slot - 1) % n
    seg = torch.linalg.norm(pose[:3] - traj.pose[prev_slot, :3])
    new_len = torch.where(traj.count > 0, traj.cumlen[prev_slot] + seg,
                          torch.zeros_like(seg))
    ts, poses, cumlen = traj.ts.clone(), traj.pose.clone(), traj.cumlen.clone()
    ts[slot] = t
    poses[slot] = pose
    cumlen[slot] = new_len
    return Trajectory(ts=ts, pose=poses, cumlen=cumlen,
                      cursor=traj.cursor + 1,
                      count=torch.clamp(traj.count + 1, max=n))


def nearest_index(traj: Trajectory, t) -> torch.Tensor:
    """Index of the sample whose timestamp is closest to t (invalid = +inf)."""
    return torch.argmin(torch.abs(traj.ts - t))


def pose_at(traj: Trajectory, t) -> torch.Tensor:
    """Pose of the nearest-in-time sample (reference: pose_by_appro_ts)."""
    return traj.pose[nearest_index(traj, t)]


def length_between(traj: Trajectory, t0, t1) -> torch.Tensor:
    """Path length travelled between the samples nearest t0 and t1."""
    i0 = nearest_index(traj, t0)
    i1 = nearest_index(traj, t1)
    return torch.abs(traj.cumlen[i1] - traj.cumlen[i0])


def relative_pose_between(traj: Trajectory, t0, t1) -> torch.Tensor:
    """4-DoF delta pose between samples nearest t0 and t1 (yaw-only
    rotation; DroneTrajectory::get_relative_pose_by_ts(.., yaw_only=true))."""
    p0 = traj.pose[nearest_index(traj, t0)]
    p1 = traj.pose[nearest_index(traj, t1)]
    return geo.delta_pose(p0, p1)


def drift_variances(length, cov_pos_per_meter: float,
                    cov_yaw_per_meter: float, min_length: float = 1e-3):
    """(pos_var, yaw_var) accumulated over ``length`` meters of travel.

    VIO drift is covariance proportional to the distance travelled
    (DroneTrajectory::covariance_between_appro_ts, consumed at
    swarm_localization_solver.cpp:1505-1550). Works on python floats, numpy
    arrays and tensors alike.
    """
    if isinstance(length, torch.Tensor):
        length = torch.clamp(length, min=min_length)
    else:
        length = np.maximum(length, min_length)
    return cov_pos_per_meter * length, cov_yaw_per_meter * length


def path_length_np(ts, positions, t0: float, t1: float) -> float:
    """Path length along a sampled trajectory between the samples nearest
    t0 and t1 (numpy host path; mirrors length_between)."""
    if len(ts) == 0:
        return 0.0
    seg = np.linalg.norm(np.diff(positions, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    i0 = int(np.argmin(np.abs(ts - t0)))
    i1 = int(np.argmin(np.abs(ts - t1)))
    return float(abs(cum[i1] - cum[i0]))


def drift_covariance_between(traj: Trajectory, t0, t1,
                             cov_pos_per_meter: float,
                             cov_yaw_per_meter: float,
                             min_length: float = 1e-3) -> torch.Tensor:
    """4x4 odometry-drift covariance accumulated over the path t0→t1
    (params loop-5-drone.launch:50-51: vo_cov_pos_per_meter=0.002,
    vo_cov_yaw_per_meter=1e-4)."""
    pv, yv = drift_variances(length_between(traj, t0, t1),
                             cov_pos_per_meter, cov_yaw_per_meter,
                             min_length)
    return torch.diag(torch.stack([pv, pv, pv, yv]))
