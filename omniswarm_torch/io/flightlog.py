"""Flight-log dataset ingestion + measurement-level replay.

A copy of ``omniswarm_tpu/io/flightlog.py`` over the port's simulator. It
reads the original system's CSV flight logs (the format of
``swarm_localization/scripts/test_vo_datagen.py:30-56``: ``ts, ctrl_mode,
pos(3), vel(3), rpy(3), pos_sp(3), vel_sp(3), acc_sp(3), rpy_sp(3),
thr_sp, ...``) and replays several of them as a multi-drone dataset: log
positions are ground truth, VIO is derived by drift-integrating
ground-truth deltas with noise, and UWB ranges are synthesized from
inter-drone distances — the replay strategy of SimulateDronesEnv
(test_vo_datagen.py:60-140), producing a ``sim.SimData`` so the whole
downstream stack runs unchanged on real trajectories.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from omniswarm_torch.sim.simulator import (
    SimData,
    SimParams,
    delta_pose_np,
    pose_mul_np,
)


@dataclass
class FlightLog:
    ts: np.ndarray     # (T,)
    pos: np.ndarray    # (T, 3)
    vel: np.ndarray    # (T, 3)
    rpy: np.ndarray    # (T, 3)

    def pose4(self) -> np.ndarray:
        """(T, 4) [x, y, z, yaw]."""
        return np.concatenate([self.pos, self.rpy[:, 2:3]], axis=1)


def parse_flight_csv(path: str, t_start: float = 0.0,
                     t_end: float = 1e9, *, zero_yaw: bool = False,
                     yaw_only: bool = True) -> FlightLog:
    data = np.genfromtxt(path, delimiter=",")
    m = (data[:, 0] >= t_start) & (data[:, 0] <= t_end)
    data = data[m]
    rpy = data[:, 8:11].copy()
    if zero_yaw:
        rpy[:, 2] = 0.0
    if yaw_only:
        rpy[:, 0] = 0.0
        rpy[:, 1] = 0.0
    return FlightLog(ts=data[:, 0], pos=data[:, 2:5], vel=data[:, 5:8],
                     rpy=rpy)


def resample(log: FlightLog, t0: float, dt: float, n: int,
             offset: Optional[np.ndarray] = None) -> np.ndarray:
    """(n, 4) poses sampled at t0 + k*dt (nearest sample), with an optional
    xy(z) offset so several replicas of one log can fly side by side."""
    poses = log.pose4()
    out = np.zeros((n, 4))
    for k in range(n):
        t = t0 + k * dt
        i = int(np.argmin(np.abs(log.ts - t)))
        out[k] = poses[i]
    if offset is not None:
        out[:, :3] += np.asarray(offset)[None, :]
    return out


def replay_dataset(
    logs: Sequence[Tuple[str, float]],
    *,
    num_frames: int = 50,
    dt: float = 0.5,
    spacing: float = 2.5,
    vio_pos_drift_per_step: float = 0.01,
    vio_yaw_drift_per_step: float = 0.002,
    uwb_noise_std: float = 0.1,
    uwb_bias: Optional[np.ndarray] = None,
    uwb_scale: Optional[np.ndarray] = None,
    seed: int = 0,
    synth_loops: bool = False,
    loop_every: int = 5,
    loop_max_distance: float = 3.0,
) -> SimData:
    """Build a SimData from real flight logs, one (path, t_offset) per drone.

    Drones are spread on a line with ``spacing`` so ranges are informative
    even when the logs overlap in space.

    ``synth_loops``: emulate place recognition over the real trajectories
    the way the reference's simulator does (proximity-gated GT query,
    swarm_local_sim.cpp:474-529) — its bag replay carries recorded loop
    edges; the CSV logs predate the visual front-end.
    """
    rng = np.random.default_rng(seed)
    D = len(logs)
    gt = np.zeros((num_frames, D, 4))
    for d, (path, t_off) in enumerate(logs):
        log = parse_flight_csv(path)
        t0 = log.ts[0] + t_off
        gt[:, d, :] = resample(log, t0, dt, num_frames,
                               offset=np.array([spacing * d, 0.0, 0.0]))

    # drift-integrated VIO (same model as sim.generate)
    vio = np.zeros_like(gt)
    vio[0] = gt[0]
    for k in range(1, num_frames):
        d_gt = delta_pose_np(gt[k - 1], gt[k])
        noise = np.concatenate(
            [rng.normal(0, vio_pos_drift_per_step, size=(D, 3)),
             rng.normal(0, vio_yaw_drift_per_step, size=(D, 1))], axis=1)
        vio[k] = pose_mul_np(vio[k - 1], d_gt + noise)

    diff = gt[:, :, None, :3] - gt[:, None, :, :3]
    true_d = np.linalg.norm(diff, axis=-1)
    noise = rng.normal(0, uwb_noise_std, size=true_d.shape)
    noise = 0.5 * (noise + np.swapaxes(noise, 1, 2))
    # per-pair sensor miscalibration in the NodeConfig convention
    # (measured = bias + scale * true, Node::to_real_distance,
    # swarm_localization_node.cpp:88); the real swarm_nodes5.yaml carries
    # fitted values like scale 0.95 — eval/calibration.py fits these back
    meas = true_d
    if uwb_scale is not None:
        meas = meas * np.asarray(uwb_scale)[None]
    if uwb_bias is not None:
        meas = meas + np.asarray(uwb_bias)[None]
    ranges = np.maximum(meas + noise, 0.0)
    range_valid = np.ones((num_frames, D, D), bool)
    np.einsum("fdd->fd", ranges)[:] = 0.0
    np.einsum("fdd->fd", range_valid)[:] = False

    params = SimParams(num_drones=D, num_frames=num_frames, dt=dt, seed=seed,
                       vio_pos_drift_per_step=vio_pos_drift_per_step,
                       vio_yaw_drift_per_step=vio_yaw_drift_per_step,
                       uwb_noise_std=uwb_noise_std)
    loops = []
    if synth_loops:
        from omniswarm_torch.sim.simulator import proximity_loops

        loops = proximity_loops(gt, rng, loop_every=loop_every,
                                loop_max_distance=loop_max_distance)
    return SimData(params=params, times=np.arange(num_frames) * dt, gt=gt,
                   vio=vio, ranges=ranges, range_valid=range_valid,
                   loops=loops, detections=[])
