"""Data-association initializer for anonymous drone detections.

Re-design of the reference's LocalizationDAInit
(swarm_localization/src/localization_DA_init.cpp): visual
drone detectors may not know *which* drone they see — such detections carry
synthetic target IDs >= ANONYMOUS_ID_BASE (the simulator emits
``i*1000 + j``, swarm_local_sim.cpp:429-431). A DFS over assignments of
anonymous IDs to known drones verifies each hypothesis by the Mahalanobis
consistency between the detection-implied relative position and the current
estimates (DFS :153-272, verify :95-151); a consistent complete assignment
rewrites the detection IDs (:83-87).

The search space is tiny (few anonymous IDs × few drones), so this stays
host-side Python — only the verification math is vectorized.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ANONYMOUS_ID_BASE = 1000


def _detection_error(obs_dir: np.ndarray, obs_inv_dep: float,
                     pose_a: np.ndarray, pose_b: np.ndarray,
                     sphere_std: float, inv_dep_std: float) -> float:
    """Squared-Mahalanobis-style consistency of 'a sees b' vs poses."""
    c, s = np.cos(-pose_a[3]), np.sin(-pose_a[3])
    d = pose_b[:3] - pose_a[:3]
    rel = np.array([c * d[0] - s * d[1], s * d[0] + c * d[1], d[2]])
    n = np.linalg.norm(rel)
    if n < 1e-6:
        return np.inf
    ang_err = np.linalg.norm(rel / n - obs_dir)
    depth_err = obs_inv_dep - 1.0 / n
    return (ang_err / sphere_std) ** 2 + (depth_err / inv_dep_std) ** 2


def try_data_association(
    detections: Sequence,
    poses: Dict[int, np.ndarray],
    *,
    accept_thres: float = 3.345,
    sphere_std: float = 0.1,
    inv_dep_std: float = 0.3,
) -> Optional[Dict[int, int]]:
    """Assign anonymous detection target IDs to known drones.

    detections: objects with .drone_a (observer, known), .drone_b (target,
    possibly >= ANONYMOUS_ID_BASE), .direction, .inv_dep — all referring to
    (approximately) one common timestamp/keyframe.
    poses: known drone id -> (4,) current pose estimate at that time.

    Returns {anonymous_id: drone_id} or None if no consistent assignment.
    The acceptance gate mirrors DA_accept_thres (default 3.345,
    swarm_localization_node.cpp:484); errors here are per-component
    squared sums, compared against accept_thres**2.
    """
    anon_dets: Dict[int, List] = {}
    for det in detections:
        if det.drone_b >= ANONYMOUS_ID_BASE and det.drone_a in poses:
            anon_dets.setdefault(det.drone_b, []).append(det)
    if not anon_dets:
        return None

    anon_ids = sorted(anon_dets)
    known = sorted(poses)
    thres2 = accept_thres ** 2

    def candidates(aid: int, used: set) -> List[Tuple[int, float]]:
        out = []
        for d in known:
            if d in used:
                continue
            errs = []
            ok = True
            for det in anon_dets[aid]:
                if det.drone_a == d:
                    ok = False
                    break
                e = _detection_error(
                    np.asarray(det.direction), det.inv_dep,
                    poses[det.drone_a], poses[d], sphere_std, inv_dep_std)
                errs.append(e)
                if e > thres2:
                    ok = False
                    break
            if ok and errs:
                out.append((d, float(np.mean(errs))))
        return sorted(out, key=lambda t: t[1])

    assignment: Dict[int, int] = {}

    def dfs(i: int) -> bool:
        if i == len(anon_ids):
            return True
        aid = anon_ids[i]
        used = set(assignment.values())
        for d, _err in candidates(aid, used):
            assignment[aid] = d
            if dfs(i + 1):
                return True
            del assignment[aid]
        return False

    if dfs(0):
        return dict(assignment)
    return None


def rewrite_detections(detections: Sequence, mapping: Dict[int, int]) -> int:
    """In-place rewrite of anonymous target IDs; returns #rewritten."""
    n = 0
    for det in detections:
        if det.drone_b in mapping:
            det.drone_b = mapping[det.drone_b]
            n += 1
    return n
