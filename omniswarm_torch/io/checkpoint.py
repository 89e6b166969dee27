"""Estimator state checkpoint/resume.

A copy of ``omniswarm_tpu/io/checkpoint.py`` with the same on-disk format
(one ``.npz``, a JSON ``meta`` blob), so a checkpoint written by either
package loads in the other.

The reference has no checkpointing — its "recovery" is re-initialization
from live data (SURVEY §5). For production serving we add real state capture:
the full SwarmEstimator state (window keyframes, measurement buffers, ego
histories, last estimate, init status) round-trips through one .npz file, so
an estimator can resume mid-flight after a process restart — the analog of
rosbag record/replay without replaying.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from omniswarm_torch.swarm.estimator import SwarmEstimator


def save_estimator(est: "SwarmEstimator", path: str) -> None:
    from dataclasses import asdict

    blobs = {}
    meta = {
        "self_id": est.self_id,
        "finish_init": est.finish_init,
        "last_cost": float(est.last_cost),
        "solve_count": est.solve_count,
        "window_ids": est.window_ids,
        "params": asdict(est.params),
        "num_kf": len(est.window),
        "num_loops": len(est.loops),
        "num_dets": len(est.dets),
        "ego_ids": sorted(est.ego),
    }
    for i, kf in enumerate(est.window):
        meta[f"kf{i}_t"] = kf.t
        meta[f"kf{i}_drones"] = sorted(kf.vio)
        for d, pose in kf.vio.items():
            blobs[f"kf{i}_pose{d}"] = np.asarray(pose)
        meta[f"kf{i}_ranges"] = [[a, b, v] for (a, b), v in kf.ranges.items()]
    for i, lp in enumerate(est.loops):
        blobs[f"loop{i}"] = np.concatenate(
            [[lp.t_a, lp.drone_a, lp.t_b, lp.drone_b], lp.dpose,
             [lp.pos_std, lp.yaw_std]])
    for i, det in enumerate(est.dets):
        blobs[f"det{i}"] = np.concatenate(
            [[det.t, det.drone_a, det.drone_b, det.inv_dep,
              float(det.enable_depth)], det.direction])
    for d, hist in est.ego.items():
        arr = np.asarray([[t, *p] for t, p in hist])
        blobs[f"ego{d}"] = arr
    if est.estimate is not None:
        blobs["estimate"] = est.estimate
    blobs["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **blobs)


def load_estimator(path: str, device="cuda") -> "SwarmEstimator":
    from omniswarm_torch.config import SolverParams
    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.swarm.estimator import (
        DetRecord,
        KeyframeRecord,
        LoopRecord,
        SwarmEstimator,
    )

    device = resolve_device(device)         # before the file is read
    raw = np.load(path)
    meta = json.loads(bytes(raw["meta"]).decode())
    params = SolverParams(**meta["params"])
    est = SwarmEstimator(params, device=device)
    est.finish_init = meta["finish_init"]
    est.last_cost = meta["last_cost"]
    est.solve_count = meta["solve_count"]
    est.window_ids = meta["window_ids"]
    for i in range(meta["num_kf"]):
        kf = KeyframeRecord(t=meta[f"kf{i}_t"], vio={})
        for d in meta[f"kf{i}_drones"]:
            kf.vio[int(d)] = raw[f"kf{i}_pose{d}"]
        for a, b, v in meta[f"kf{i}_ranges"]:
            kf.ranges[(int(a), int(b))] = float(v)
        est.window.append(kf)
    for i in range(meta["num_loops"]):
        v = raw[f"loop{i}"]
        est.loops.append(LoopRecord(
            t_a=float(v[0]), drone_a=int(v[1]), t_b=float(v[2]),
            drone_b=int(v[3]), dpose=v[4:8], pos_std=float(v[8]),
            yaw_std=float(v[9])))
    for i in range(meta["num_dets"]):
        v = raw[f"det{i}"]
        est.dets.append(DetRecord(
            t=float(v[0]), drone_a=int(v[1]), drone_b=int(v[2]),
            inv_dep=float(v[3]), enable_depth=bool(v[4]),
            direction=v[5:8]))
    for d in meta["ego_ids"]:
        arr = raw[f"ego{d}"]
        est.ego[int(d)] = [(float(r[0]), r[1:5]) for r in arr]
    if "estimate" in raw:
        est.estimate = raw["estimate"]
    return est
