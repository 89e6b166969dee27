"""Measurement recording/replay — the rosbag record/replay analog.

A copy of ``omniswarm_tpu/io/recorder.py`` with the same on-disk format.

The reference's system-level state capture is rosbag recording of all input
topics and offline replay (bag-replay.launch:99-117). Here: a Recorder
taps the estimator-facing measurement stream (swarm frames, loop edges,
detections), serializes to one .npz, and replays into any consumer —
enabling offline re-processing, regression datasets, and ablation runs on
captured flights.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from omniswarm_torch.swarm.estimator import DetRecord, LoopRecord


@dataclass
class Recording:
    frames: List[Tuple[float, Dict[int, np.ndarray],
                       Dict[Tuple[int, int], float]]] = field(
        default_factory=list)
    loops: List[LoopRecord] = field(default_factory=list)
    dets: List[DetRecord] = field(default_factory=list)

    def save(self, path: str) -> None:
        blobs = {}
        meta = {"num_frames": len(self.frames), "num_loops": len(self.loops),
                "num_dets": len(self.dets)}
        for i, (t, vio, ranges) in enumerate(self.frames):
            meta[f"f{i}_t"] = t
            meta[f"f{i}_drones"] = sorted(vio)
            meta[f"f{i}_ranges"] = [[a, b, v]
                                    for (a, b), v in ranges.items()]
            for d, pose in vio.items():
                blobs[f"f{i}_p{d}"] = np.asarray(pose)
        for i, lp in enumerate(self.loops):
            blobs[f"l{i}"] = np.concatenate(
                [[lp.t_a, lp.drone_a, lp.t_b, lp.drone_b], lp.dpose,
                 [lp.pos_std, lp.yaw_std]])
        for i, det in enumerate(self.dets):
            blobs[f"d{i}"] = np.concatenate(
                [[det.t, det.drone_a, det.drone_b, det.inv_dep,
                  float(det.enable_depth)], det.direction])
        blobs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        np.savez_compressed(path, **blobs)

    @staticmethod
    def load(path: str) -> "Recording":
        raw = np.load(path)
        meta = json.loads(bytes(raw["meta"]).decode())
        rec = Recording()
        for i in range(meta["num_frames"]):
            vio = {int(d): raw[f"f{i}_p{d}"] for d in meta[f"f{i}_drones"]}
            ranges = {(int(a), int(b)): float(v)
                      for a, b, v in meta[f"f{i}_ranges"]}
            rec.frames.append((meta[f"f{i}_t"], vio, ranges))
        for i in range(meta["num_loops"]):
            v = raw[f"l{i}"]
            rec.loops.append(LoopRecord(
                t_a=float(v[0]), drone_a=int(v[1]), t_b=float(v[2]),
                drone_b=int(v[3]), dpose=v[4:8], pos_std=float(v[8]),
                yaw_std=float(v[9])))
        for i in range(meta["num_dets"]):
            v = raw[f"d{i}"]
            rec.dets.append(DetRecord(
                t=float(v[0]), drone_a=int(v[1]), drone_b=int(v[2]),
                inv_dep=float(v[3]), enable_depth=bool(v[4]),
                direction=v[5:8]))
        return rec

    # ------------------------------------------------------------------
    def record_frame(self, t, vio, ranges) -> None:
        self.frames.append(
            (float(t), {int(d): np.asarray(p) for d, p in vio.items()},
             {(int(a), int(b)): float(v) for (a, b), v in ranges.items()}))

    def replay_into(self, estimator) -> None:
        """Feed the recording into a SwarmEstimator (or API-compatible)."""
        for t, vio, ranges in self.frames:
            estimator.on_swarm_frame(t, vio, ranges)
        for lp in self.loops:
            estimator.on_loop(lp)
        for det in self.dets:
            estimator.on_detection(det)
