"""Per-drone node: front-end keyframes, network, detector and estimator.

Counterpart of ``omniswarm_tpu/swarm/node.py`` (:28-155): every drone runs
an identical ``DroneNode``, and the only coupling between nodes is the
multicast bus (keyframes, loop edges, PCM inlier sets) and the UWB
range/odometry frames. A local keyframe passes the reference's gates
(``max_freq``, the non-keyframe waits, ``min_movement_keyframe`` for
match-only frames) before the detector sees it; remote keyframes are queued
and drained as one detector tick per ``step``; ``solve`` broadcasts the PCM
inlier sets it computed. The detector and the estimator run on ``device``
(the GPU unless the CPU is asked for).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from omniswarm_torch.config import FrontendParams, SolverParams
from omniswarm_torch.swarm.comm import (
    InlierSetPacket,
    KeyframeData,
    LoopEdgePacket,
    LoopNet,
)
from omniswarm_torch.swarm.estimator import LoopRecord, SwarmEstimator
from omniswarm_torch.swarm.loop_detector import LoopDetector


class DroneNode:
    def __init__(self, drone_id: int, bus, *,
                 solver_params: Optional[SolverParams] = None,
                 frontend_params: Optional[FrontendParams] = None,
                 node_configs=None, global_dim: int = 4096, seed: int = 0,
                 device="cuda"):
        self.drone_id = drone_id
        sp = solver_params or SolverParams()
        sp.self_id = drone_id
        self.estimator = SwarmEstimator(sp, node_configs=node_configs,
                                        rng_seed=seed, device=device)
        self.detector = LoopDetector(drone_id, frontend_params,
                                     global_dim=global_dim, seed=seed,
                                     device=device)
        self.net = LoopNet(bus, drone_id,
                           on_keyframe=self._on_remote_keyframe,
                           on_loop=self._on_loop_edge,
                           on_inliers=self._on_inlier_set)
        self.loops_found = 0
        self.loops_received = 0
        # remote keyframes queue: drained as ONE serving batch per comm
        # scan (two fused dispatches for the whole batch instead of ~3
        # round trips per keyframe)
        self._rx_kfs = []
        # front-end keyframe gating state (VIOKF_callback/VIOnonKF_callback,
        # swarm_loop.cpp:124-170)
        self._last_invoke = -np.inf
        self._last_kf_time = -np.inf
        self._last_kf_pos: Optional[np.ndarray] = None
        self._received_image = False

    # ------------------------------------------------------------------
    def on_swarm_frame(self, t: float, vio: Dict[int, np.ndarray],
                       ranges: Dict[Tuple[int, int], float]) -> bool:
        return self.estimator.on_swarm_frame(t, vio, ranges)

    def on_local_keyframe(self, kf: KeyframeData, t: float,
                          is_keyframe: bool = True) -> None:
        """A frame from this drone's own camera/frontend.

        ``is_keyframe=False`` is the VIO non-keyframe path
        (VIOnonKF_callback, swarm_loop.cpp:124-138): promoted to a full
        keyframe if no image was processed yet (after
        init_nonkeyframe_waitsec) or no keyframe arrived for
        nonkeyframe_waitsec — then match-only if movement is small.
        """
        p = self.detector.p
        nonkeyframe = not is_keyframe
        if nonkeyframe:
            waited = t - self._last_kf_time
            if not self._received_image \
                    and waited > p.init_nonkeyframe_waitsec:
                nonkeyframe = False
            elif waited <= p.nonkeyframe_waitsec:
                return
        # rate gate (max_freq, VIOKF_callback swarm_loop.cpp:145-147)
        if t - self._last_invoke < 1.0 / p.max_freq:
            return
        self._last_invoke = t
        self._last_kf_time = t
        pos = np.asarray(kf.pose, float)[:3]
        dpos = np.inf if self._last_kf_pos is None else \
            float(np.linalg.norm(pos - self._last_kf_pos))
        prevent = nonkeyframe and dpos < p.min_movement_keyframe
        if prevent and kf.prevent_adding_db is False:
            kf = KeyframeData(**{**kf.__dict__, "prevent_adding_db": True})
        self._received_image = True
        self._last_kf_pos = pos
        cands = self.detector.on_keyframe_multi(kf, prevent_adding_db=prevent)
        self.net.broadcast_keyframe(kf, t)
        for cand in cands:
            self.loops_found += 1
            self._ingest_loop(cand.edge)
            self.net.broadcast_loop_edge(cand.edge, t)

    def on_detection(self, det) -> None:
        """Visual drone-to-drone detection (node_detected intake,
        swarm_localization_node.cpp:146-154); ``det.drone_b`` may be an
        anonymous ID (>= ANONYMOUS_ID_BASE) resolved later by DA-init."""
        self.estimator.on_detection(det)

    def step(self, t: float) -> None:
        """Periodic comm scan (the reference's 100 Hz timer) + batched
        processing of the received keyframes."""
        self.net.scan_recv_packets(t)
        if self._rx_kfs:
            kfs, self._rx_kfs = self._rx_kfs, []
            batches = self.detector.on_keyframes_batch(
                kfs, [kf.prevent_adding_db for kf in kfs])
            for kf, cands in zip(kfs, batches):
                for cand in cands:
                    self.loops_found += 1
                    self._ingest_loop(cand.edge)
                    self.net.broadcast_loop_edge(cand.edge, kf.t)

    def solve(self, t: float = 0.0):
        out = self.estimator.solve()
        # broadcast the PCM inlier sets this node computed (LOOP_INLIERS
        # division of labor: peers adopt instead of recomputing,
        # swarm_outlier_rejection.cpp:73-96)
        for pair, keys in self.estimator.pair_inliers.items():
            self.net.broadcast_inlier_set(
                InlierSetPacket(drone_a=pair[0], drone_b=pair[1],
                                loop_keys=sorted(keys)), t)
        return out

    # ------------------------------------------------------------------
    def _on_remote_keyframe(self, kf: KeyframeData) -> None:
        # queued; drained as one serving batch by step()
        self._rx_kfs.append(kf)

    def _on_loop_edge(self, pkt: LoopEdgePacket) -> None:
        self.loops_received += 1
        self._ingest_loop(pkt)

    def _on_inlier_set(self, pkt: InlierSetPacket) -> None:
        pair = (min(pkt.drone_a, pkt.drone_b), max(pkt.drone_a, pkt.drone_b))
        if self.drone_id in pair:
            return                      # we compute our own pairs
        self.estimator.external_inliers[pair] = {
            tuple(k) for k in pkt.loop_keys}

    def _ingest_loop(self, edge: LoopEdgePacket) -> None:
        self.estimator.on_loop(LoopRecord(
            t_a=edge.t_a, drone_a=edge.drone_a,
            t_b=edge.t_b, drone_b=edge.drone_b,
            dpose=np.asarray(edge.dpose, float),
            pos_std=edge.pos_std, yaw_std=edge.yaw_std,
            dpose6=None if edge.dpose6 is None
            else np.asarray(edge.dpose6, float)))
