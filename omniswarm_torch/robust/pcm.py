"""Pairwise-Consistency-Maximization (PCM) loop outlier rejection.

Counterpart of ``omniswarm_tpu/robust/pcm.py`` (the reference's
SwarmLocalOutlierRejection, swarm_outlier_rejection.cpp:98-297):

- the O(L^2) pairwise cycle-consistency errors are one broadcast torch
  computation over the whole loop set on the device (4-DoF pose algebra of
  ``core/geometry.py``), run under ``highp``;
- the max-clique inlier search stays on the host, in the native C++
  heuristic (``runtime/native.py``);
- only drone pairs involving ``self_id`` are computed unless ``redundant``
  (the reference broadcasts the inlier sets, :122-139).

Consistency metric (:228-236): for two loops p_i, p_j between the same drone
pair, err = odom_a ∘ p_j ∘ odom_b^-1 ∘ p_i^-1 where odom_a/odom_b are the
drones' ego-motion between the loops' endpoints; the squared Mahalanobis
distance of err under (cov_i + cov_j + odom drift covariances) must stay
below ``pcm_thres``.

The reference pads the loop count to powers of two and the frames to
multiples of 64 (one compile per bucket) and packs the mask to bits for a
remote link; here the (L, L) bool mask is computed at its true size and
copied as it is. Padded rows were masked and sliced away, so the verdicts
are the same.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from omniswarm_torch.core import geometry as geo
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.runtime.native import max_clique
from omniswarm_torch.utils.telemetry import GLOBAL as _telemetry


class LoopSet(NamedTuple):
    """Canonicalized loop measurements as struct-of-arrays (numpy).

    Canonical form: drone_a <= drone_b (edges flipped on ingest), so the
    reference's same_robot_pair==2 reversed case never arises.
    """

    frame_a: np.ndarray   # (L,)
    drone_a: np.ndarray   # (L,)
    frame_b: np.ndarray   # (L,)
    drone_b: np.ndarray   # (L,)
    dpose: np.ndarray     # (L, 4)
    cov_diag: np.ndarray  # (L, 4) diagonal covariance [x, y, z, yaw]


def loopset_from_measurements(loops: Sequence) -> LoopSet:
    """Build a canonical LoopSet from sim.LoopMeas-like objects."""
    L = len(loops)
    fa = np.zeros(L, np.int32)
    da = np.zeros(L, np.int32)
    fb = np.zeros(L, np.int32)
    db = np.zeros(L, np.int32)
    dp = np.zeros((L, 4), np.float32)
    cov = np.zeros((L, 4), np.float32)
    for i, lp in enumerate(loops):
        dpose = np.asarray(lp.dpose, np.float32)
        a = (lp.frame_a, lp.drone_a)
        b = (lp.frame_b, lp.drone_b)
        if lp.drone_a > lp.drone_b:
            a, b = b, a
            dpose = geo.pose_inv(torch.from_numpy(dpose)).numpy()
        fa[i], da[i] = a
        fb[i], db[i] = b
        dp[i] = dpose
        cov[i] = [lp.pos_std**2] * 3 + [lp.yaw_std**2]
    return LoopSet(fa, da, fb, db, dp, cov)


@highp()
def consistency_matrix(frame_a, drone_a, frame_b, drone_b, dpose, cov_diag,
                       vio, cumlen, *, vo_cov_pos_per_meter: float = 0.002,
                       vo_cov_yaw_per_meter: float = 0.0001
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L) f32 squared-Mahalanobis matrix + same-drone-pair mask.

    Tensors on one device: indices (L,) int64, dpose and cov_diag (L, 4),
    vio (F, D, 4) ego-motion poses, cumlen (F, D) cumulative arclength.
    """
    # ego-motion of drone a between the two loops' a-endpoints, for all (i, j)
    pa_i = vio[frame_a, drone_a]                                  # (L, 4)
    pb_i = vio[frame_b, drone_b]
    odom_a = geo.delta_pose(pa_i[:, None, :], pa_i[None, :, :])   # (L, L, 4)
    odom_b = geo.delta_pose(pb_i[:, None, :], pb_i[None, :, :])

    p_i = dpose[:, None, :]
    p_j = dpose[None, :, :]
    # err = odom_a ∘ p_j ∘ odom_b^-1 ∘ p_i^-1  (outlier_rejection.cpp:228)
    err = geo.pose_mul(
        geo.pose_mul(geo.pose_mul(odom_a, p_j), geo.pose_inv(odom_b)),
        geo.pose_inv(torch.broadcast_to(p_i, odom_a.shape)))

    # drift covariance along each drone's path between the endpoints
    ca = cumlen[frame_a, drone_a]
    cb = cumlen[frame_b, drone_b]
    path = (torch.abs(ca[:, None] - ca[None, :])
            + torch.abs(cb[:, None] - cb[None, :]))
    drift = torch.stack([vo_cov_pos_per_meter * path] * 3
                        + [vo_cov_yaw_per_meter * path], -1)
    cov = cov_diag[:, None, :] + cov_diag[None, :, :] + drift

    err = torch.cat([err[..., :3], geo.normalize_angle(err[..., 3:])], -1)
    smd = torch.sum(err * err / torch.clamp_min(cov, 1e-12), -1)
    same_pair = ((drone_a[:, None] == drone_a[None, :])
                 & (drone_b[:, None] == drone_b[None, :]))
    return smd, same_pair


def consistency_mask(frame_a, drone_a, frame_b, drone_b, dpose, cov_diag,
                     vio, cumlen, thres: float, *,
                     vo_cov_pos_per_meter: float = 0.002,
                     vo_cov_yaw_per_meter: float = 0.0001) -> torch.Tensor:
    """Thresholded (L, L) bool consistency, on the inputs' device."""
    smd, same_pair = consistency_matrix(
        frame_a, drone_a, frame_b, drone_b, dpose, cov_diag, vio, cumlen,
        vo_cov_pos_per_meter=vo_cov_pos_per_meter,
        vo_cov_yaw_per_meter=vo_cov_yaw_per_meter)
    return (smd < thres) & same_pair


def _cumlen(vio: np.ndarray) -> np.ndarray:
    """(F, D) f32 cumulative VIO path length along the frame axis."""
    seg = np.linalg.norm(np.diff(vio[:, :, :3], axis=0), axis=-1)
    return np.concatenate([np.zeros((1, seg.shape[1])),
                           np.cumsum(seg, 0)], 0).astype(np.float32)


def _device_inputs(loops: LoopSet, rows: np.ndarray, vio: np.ndarray,
                   cumlen: np.ndarray, dev: torch.device):
    """The consistency inputs of loops ``rows``, uploaded to ``dev``."""
    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    i64, f32 = torch.int64, torch.float32
    return (t(loops.frame_a[rows], i64), t(loops.drone_a[rows], i64),
            t(loops.frame_b[rows], i64), t(loops.drone_b[rows], i64),
            t(loops.dpose[rows], f32), t(loops.cov_diag[rows], f32),
            t(vio, f32), t(cumlen, f32))


def pcm_launch_all(loops: LoopSet, vio: np.ndarray, *, device="cuda",
                   pcm_thres: float = 0.6,
                   vo_cov_pos_per_meter: float = 0.002,
                   vo_cov_yaw_per_meter: float = 0.0001) -> dict:
    """Phase 1 of an all-pairs PCM pass: upload and enqueue the consistency
    mask on ``device`` and return a handle without waiting for it. The
    device runs it while the caller does other work (the LM solve);
    ``pcm_finish_all`` copies the mask and runs the max-cliques later."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    vio = np.asarray(vio, np.float32)
    n = loops.frame_a.shape[0]
    mask = consistency_mask(
        *_device_inputs(loops, np.arange(n), vio, _cumlen(vio), dev),
        pcm_thres, vo_cov_pos_per_meter=vo_cov_pos_per_meter,
        vo_cov_yaw_per_meter=vo_cov_yaw_per_meter)
    return {"mask": mask, "n": n, "loops": loops, "t0": t0}


@dataclass
class PCMResult:
    good_mask: np.ndarray                 # (L,) bool
    pair_inliers: Dict[Tuple[int, int], np.ndarray]  # pair -> loop indices
    smd: Optional[np.ndarray]             # (L, L) errors (return_smd only)


def _pair_clique(consistent: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Which of one pair's loops (rows ``pos`` of ``consistent``) PCM keeps,
    as indices into ``pos``."""
    if pos.size == 1:
        return np.zeros(1, np.int64)
    return max_clique(consistent[np.ix_(pos, pos)])


def pcm_finish_all(handle: dict) -> PCMResult:
    """Phase 2: copy the mask to the host (usually ready) and run the
    per-pair max-cliques. Equivalent to pcm_filter(..., redundant=True,
    return_smd=False) over the launched loop set. Records telemetry
    ``pcm.finish`` (this call) and ``pcm.launch_to_finish`` (since the
    launch began)."""
    t1 = time.perf_counter()
    loops = handle["loops"]
    consistent = handle["mask"].cpu().numpy()
    np.fill_diagonal(consistent, False)
    good = np.zeros(handle["n"], bool)
    pair_inliers: Dict[Tuple[int, int], np.ndarray] = {}
    pairs = {(int(a), int(b)) for a, b in zip(loops.drone_a, loops.drone_b)}
    for pair in sorted(pairs):
        idx = np.flatnonzero((loops.drone_a == pair[0])
                             & (loops.drone_b == pair[1]))
        sel = idx[_pair_clique(consistent, idx)]
        good[sel] = True
        pair_inliers[pair] = sel
    t2 = time.perf_counter()
    _telemetry.record_ms("pcm.finish", (t2 - t1) * 1e3)
    _telemetry.record_ms("pcm.launch_to_finish", (t2 - handle["t0"]) * 1e3)
    return PCMResult(good, pair_inliers, None)


def pcm_filter(
    loops: LoopSet,
    vio: np.ndarray,
    *,
    device="cuda",
    pcm_thres: float = 0.6,
    self_id: int = -1,
    redundant: bool = True,
    vo_cov_pos_per_meter: float = 0.002,
    vo_cov_yaw_per_meter: float = 0.0001,
    external_inliers: Dict[Tuple[int, int], np.ndarray] | None = None,
    return_smd: bool = True,
) -> PCMResult:
    """Select the PCM-consistent inlier subset of a loop set.

    ``redundant=False`` computes only pairs involving ``self_id``; other
    pairs fall back to ``external_inliers`` (peer-broadcast sets, the LCM
    LOOP_INLIERS channel equivalent) or accept-all — matching
    swarm_outlier_rejection.cpp:122-158. Only loops whose pair is computed
    locally enter the consistency mask; ``return_smd=True`` also returns the
    full (L, L) smd matrix (forensics).
    """
    L = loops.frame_a.shape[0]
    if L == 0:
        return PCMResult(np.zeros(0, bool), {},
                         np.zeros((0, 0)) if return_smd else None)
    dev = resolve_device(device)
    vio = np.asarray(vio, np.float32)
    cumlen = _cumlen(vio)
    kw = dict(vo_cov_pos_per_meter=vo_cov_pos_per_meter,
              vo_cov_yaw_per_meter=vo_cov_yaw_per_meter)

    compute_all = redundant or self_id < 0
    if compute_all:
        sub = np.arange(L)
    else:
        sub = np.flatnonzero((loops.drone_a == self_id)
                             | (loops.drone_b == self_id))
    consistent = None
    if sub.size:
        consistent = consistency_mask(
            *_device_inputs(loops, sub, vio, cumlen, dev), pcm_thres,
            **kw).cpu().numpy()
        np.fill_diagonal(consistent, False)
    sub_pos = np.zeros(L, np.int64)
    sub_pos[sub] = np.arange(sub.size)

    smd = None
    if return_smd:
        smd_dev, _ = consistency_matrix(
            *_device_inputs(loops, np.arange(L), vio, cumlen, dev), **kw)
        smd = smd_dev.cpu().numpy()

    good = np.zeros(L, bool)
    pair_inliers: Dict[Tuple[int, int], np.ndarray] = {}
    pairs = {(int(a), int(b)) for a, b in zip(loops.drone_a, loops.drone_b)}
    for pair in sorted(pairs):
        idx = np.flatnonzero((loops.drone_a == pair[0])
                             & (loops.drone_b == pair[1]))
        if not (compute_all or self_id in pair):
            ext = (external_inliers or {}).get(pair)
            if ext is None:
                good[idx] = True           # no inlier set known: accept all
            else:
                good[np.intersect1d(idx, ext)] = True
                pair_inliers[pair] = np.intersect1d(idx, ext)
            continue
        sel = idx[_pair_clique(consistent, sub_pos[idx])]
        good[sel] = True
        pair_inliers[pair] = sel
    return PCMResult(good, pair_inliers, smd)
