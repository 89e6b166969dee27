"""The production node: one drone's onboard stack, fed JSON lines on stdin.

Counterpart of ``tools/run_node.py``, the reference's
``swarm_localization_node``. A YAML config (``config.SwarmConfig``) makes
the ``SwarmEstimator``, a ``LocalProxy`` for the UWB frames, a
``FusedDownlink`` for the fused states and, unless ``--no-udp``, a
``DroneNode`` (its ``LoopDetector`` and ``LoopNet``) over a
``UdpMulticastBus``. After every message the node runs the reference's
cadence (:184-215): the bus and the node's comm scan, the lines of the
solves that finished, a solve at ``force_freq`` on a worker thread (a tick
that finds one in flight is skipped), a prediction at ``predict_freq``.
A solve is the estimator's three phases: ``prepare_solve`` under the
ingest lock, ``execute_solve`` (the device solve) without it,
``finalize_solve`` under it again; then the node broadcasts its PCM inlier
sets.

Input, one JSON object a line (:11-17, :127-182)::

    {"type": "vio",   "t": 1.0, "pose": [x, y, z, yaw], "vel": [vx, vy, vz]}
    {"type": "uwb",   "t": 1.0, "distances": {"1": 3.2, "2": 5.1}}
    {"type": "frame", "t": 1.0, "vio": {"0": [x, y, z, yaw]},
                      "ranges": [[0, 1, 3.2]]}
    {"type": "det",   "t": 1.0, "source": 0, "target": 2,
                      "direction": [dx, dy, dz], "inv_dep": 0.3}
    {"type": "quit"}

Output lines: ``{"type": "solve", "t": <tick>, <the solve's status>}`` and
``{"type": "predict", "t": <tick>, "poses": {"<drone>": [x, y, z, yaw]}}``.

    python -m omniswarm_torch.runtime.run_node --config configs/swarm5.yaml \\
        [--drone-id N] [--port 7667] [--no-udp] [--device cuda|cpu]

``--device`` takes the place of the reference's ``OMNISWARM_TPU``
switch: the estimator and the detector run on the card unless the CPU is
asked for, and the node raises without CUDA. A host that refuses the
multicast socket gets a ``warn`` line and a node that runs alone, as in
the reference. ``NodeLoop`` is the loop body, one method a message; it
takes the estimator and a ``NodeKit`` of the package's classes, so a test
can drive the reference's estimator through the same code.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np


class NodeKit(NamedTuple):
    """The classes the loop makes or feeds, of one package."""
    DetRecord: type
    LocalProxy: type
    FusedDownlink: type
    NodeDetectedPacket: type
    InlierSetPacket: type


def port_kit() -> NodeKit:
    from omniswarm_torch.swarm.comm import InlierSetPacket
    from omniswarm_torch.swarm.estimator import DetRecord
    from omniswarm_torch.swarm.proxy import (FusedDownlink, LocalProxy,
                                             NodeDetectedPacket)

    return NodeKit(DetRecord, LocalProxy, FusedDownlink, NodeDetectedPacket,
                   InlierSetPacket)


def print_line(record: dict) -> None:
    print(json.dumps(record), flush=True)


def _json_safe(out: dict) -> dict:
    """A solve status with its non-finite floats as None (JSON has no NaN)."""
    return {k: (v if not isinstance(v, float) or np.isfinite(v) else None)
            for k, v in out.items()}


def _poses(pred: Dict[int, np.ndarray]) -> Dict[str, list]:
    return {str(d): [round(float(x), 4) for x in p] for d, p in pred.items()}


class NodeLoop:
    """The node's loop body.

    ``handle(msg)`` takes one decoded input line (one ``on_*`` method per
    type, then ``tick``); ``wait()`` blocks until the solve in flight, if
    any, has finished; ``finish()`` ends a session as the reference's loop
    does after its input (waits, drains, emits the final prediction,
    closes the bus). Output records go to ``emit``.

    ``threaded=False`` runs each solve inline on the calling thread;
    ``paced=True`` starts it on the worker thread and waits for it before
    the tick goes on, so a session is deterministic and can be held bit
    for bit to the inline one.

    The cadence record: ``dispatched`` solves, ``skipped_busy`` messages
    (a solve due and one in flight), each solve's wall ms from dispatch to
    its result (``solve_wall_ms``), each gap between two predictions on
    the wall clock with whether a solve was in flight during it
    (``predict_gaps``), and each prediction's own wall ms (the ingest
    lock, ``predict_swarm`` and its line) with whether a solve was in
    flight when it began (``predict_ms``).
    """

    def __init__(self, estimator, kit: NodeKit, *, self_id: int,
                 force_freq: float, predict_freq: float, node=None,
                 bus=None, threaded: bool = True, paced: bool = False,
                 emit: Callable[[dict], None] = print_line):
        self.estimator = estimator
        self.kit = kit
        self.self_id = self_id
        self.node = node
        self.bus = bus
        self.threaded = threaded
        self.paced = paced
        self.emit = emit
        self.lock = threading.RLock()
        self._idle = threading.Event()
        self._idle.set()
        self._results: "queue.Queue" = queue.Queue()
        self.proxy = kit.LocalProxy(self_id, on_frame=self._on_proxy_frame)
        self.downlink = kit.FusedDownlink(self_id, send_freq=predict_freq)
        self.solve_period = 1.0 / max(force_freq, 1e-3)
        self.predict_period = 1.0 / max(predict_freq, 1e-3)
        self.last_solve = -np.inf
        self.last_predict = -np.inf
        self.dispatched = 0
        self.skipped_busy = 0
        self.solve_wall_ms: List[float] = []
        self.predict_gaps: List[Tuple[float, bool]] = []
        self.predict_ms: List[Tuple[float, bool]] = []
        self._last_predict_wall: Optional[float] = None
        self._done = 0                   # solves finished (worker side)
        self._done_at_predict = 0

    # ---------------- input messages ----------------
    def handle(self, msg: dict) -> bool:
        """One input line; False on ``quit``."""
        t = float(msg.get("t", 0.0))
        kind = msg.get("type")
        if kind == "vio":
            self.on_vio(t, msg["pose"], msg.get("vel", [0, 0, 0]))
        elif kind == "uwb":
            self.on_uwb(t, msg.get("distances", {}))
        elif kind == "frame":
            self.on_frame(t, msg.get("vio", {}), msg.get("ranges", []))
        elif kind == "det":
            self.on_det(t, msg)
        elif kind == "quit":
            return False
        self.tick(t)
        return True

    def on_vio(self, t: float, pose, vel) -> None:
        pose = np.asarray(pose, float)
        with self.lock:
            self.proxy.on_self_odometry(t, pose, np.asarray(vel, float))
            self.estimator.on_vio(t, self.self_id, pose)

    def on_uwb(self, t: float, distances: dict) -> None:
        with self.lock:
            self.proxy.on_uwb_tick(t, {int(k): float(v)
                                       for k, v in distances.items()})

    def on_frame(self, t: float, vio: dict, ranges: list) -> None:
        vio = {int(k): np.asarray(v, float) for k, v in vio.items()}
        ranges = {(int(a), int(b)): float(v) for a, b, v in ranges}
        with self.lock:
            self.estimator.on_swarm_frame(t, vio, ranges)

    def on_det(self, t: float, msg: dict) -> None:
        """A visual drone detection from an external detector: ingested
        here and framed for the narrowband radio (send_node_detected)."""
        direction = np.asarray(msg["direction"], float)
        inv_dep = float(msg.get("inv_dep", 0.0))
        with self.lock:
            self.estimator.on_detection(self.kit.DetRecord(
                t=t, drone_a=int(msg.get("source", self.self_id)),
                drone_b=int(msg["target"]), direction=direction,
                inv_dep=inv_dep,
                enable_depth=bool(msg.get("enable_depth", True))))
        if inv_dep > 1e-6:
            # the framed packet would go out on the narrowband radio
            self.proxy.broadcast_detection(self.kit.NodeDetectedPacket(
                t=t, source_id=self.self_id,
                remote_drone_id=int(msg["target"]),
                detection_id=int(msg.get("id", 0)),
                rel_pos=direction / inv_dep,
                rel_yaw=float(msg.get("rel_yaw", 0.0)),
                pos_std=np.asarray(msg.get("pos_std", [0.1, 0.1, 0.1]),
                                   float),
                yaw_std=float(msg.get("yaw_std", 0.1))))

    def _on_proxy_frame(self, sf) -> None:
        with self.lock:
            self.estimator.on_swarm_frame(
                sf.t, {d: p for d, (p, _v) in sf.nodes.items()}, sf.ranges)

    # ---------------- the cadence ----------------
    def tick(self, t: float) -> None:
        if self.bus is not None:
            self.bus.step(t)
        if self.node is not None:
            with self.lock:
                self.node.step(t)
        self.drain()
        if t - self.last_solve >= self.solve_period:
            if self._idle.is_set():
                self.last_solve = t
                self._dispatch(t)
            else:
                self.skipped_busy += 1
        if (t - self.last_predict >= self.predict_period
                and self.estimator.finish_init):
            self.last_predict = t
            self._predict(t)

    def _dispatch(self, t: float) -> None:
        self.dispatched += 1
        self._idle.clear()
        if not self.threaded:
            self._solve(t, time.perf_counter())
            return
        threading.Thread(target=self._solve, args=(t, time.perf_counter()),
                         daemon=True).start()
        if self.paced:
            self.wait()

    def _solve(self, t_req: float, wall0: float) -> None:
        est = self.estimator
        try:
            with self.lock:
                prep = est.prepare_solve()
            if prep.get("refused"):
                out = prep["status"]
            else:
                res = est.execute_solve(prep)        # without the lock
                with self.lock:
                    out = est.finalize_solve(prep, res)
                if self.node is not None:
                    for pair, keys in est.pair_inliers.items():
                        self.node.net.broadcast_inlier_set(
                            self.kit.InlierSetPacket(
                                drone_a=pair[0], drone_b=pair[1],
                                loop_keys=sorted(keys)), t_req)
                self.solve_wall_ms.append(
                    (time.perf_counter() - wall0) * 1e3)
            self._results.put((t_req, out))
        except Exception as e:           # reported as the reference does
            self._results.put((t_req, {"solved": False, "reason": repr(e)}))
        finally:
            self._done += 1
            self._idle.set()

    def drain(self) -> None:
        """Emit the lines of the solves that finished."""
        while not self._results.empty():
            t_req, out = self._results.get_nowait()
            self.emit({"type": "solve", "t": t_req, **_json_safe(out)})

    def _predict(self, t: float) -> None:
        now = time.perf_counter()
        in_flight = not self._idle.is_set()
        if self._last_predict_wall is not None:
            busy = in_flight or self._done != self._done_at_predict
            self.predict_gaps.append((now - self._last_predict_wall, busy))
        self._last_predict_wall = now
        self._done_at_predict = self._done
        with self.lock:
            pred = self.estimator.predict_swarm(t)
        self.emit({"type": "predict", "t": t, "poses": _poses(pred)})
        self.predict_ms.append(((time.perf_counter() - now) * 1e3,
                                in_flight))
        # the packet would go out on the narrowband radio
        self.downlink.tick(t, {d: p for d, p in pred.items()
                               if d != self.self_id})

    def wait(self) -> None:
        self._idle.wait()

    def finish(self) -> None:
        """End of input: wait for the solve in flight, emit its line and
        the final prediction at the last solve's tick (the replay can end
        before the solve lands), close the bus."""
        self.wait()
        self.drain()
        if self.estimator.finish_init:
            pred = self.estimator.predict_swarm(self.last_solve)
            if pred:
                self.emit({"type": "predict", "t": self.last_solve,
                           "poses": _poses(pred)})
        if self.bus is not None:
            self.bus.close()

    def cadence(self) -> dict:
        """The cadence record as numbers: percentiles of the prediction
        gaps and of the predictions' own times, in ms, with a solve in
        flight and without."""
        def split(rows, scale):
            out = {}
            for name, busy in (("in_flight", True), ("idle", False)):
                ms = [v * scale for v, b in rows if b == busy]
                out[name] = dict(
                    p50=float(np.percentile(ms, 50)) if ms else None,
                    p99=float(np.percentile(ms, 99)) if ms else None,
                    count=len(ms))
            return out

        return dict(
            dispatched=self.dispatched, skipped_busy=self.skipped_busy,
            solve_wall_ms_median=(float(np.median(self.solve_wall_ms))
                                  if self.solve_wall_ms else None),
            predict_gap_ms=split(self.predict_gaps, 1e3),
            predict_ms=split(self.predict_ms, 1.0))


def run_lines(loop: NodeLoop, lines) -> None:
    """Feed JSON lines to ``loop`` until ``quit`` or their end, then
    ``finish`` (lines that are not JSON are skipped)."""
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not loop.handle(msg):
            break
    loop.finish()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--drone-id", type=int, default=None)
    ap.add_argument("--port", type=int, default=7667)
    ap.add_argument("--no-udp", action="store_true",
                    help="disable the multicast transport (solo replay)")
    ap.add_argument("--device", default="cuda",
                    help="where the estimator and detector run")
    args = ap.parse_args(argv)

    from omniswarm_torch.config import SwarmConfig
    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.swarm.estimator import SwarmEstimator
    from omniswarm_torch.utils.diagnostics import install_crash_handler

    install_crash_handler()
    dev = resolve_device(args.device)
    cfg = SwarmConfig.from_yaml(args.config)
    self_id = args.drone_id if args.drone_id is not None else cfg.self_id
    cfg.solver.self_id = self_id

    estimator = SwarmEstimator(cfg.solver, node_configs=cfg.nodes,
                               device=dev)
    node = bus = None
    if not args.no_udp:
        try:
            from omniswarm_torch.runtime.udp_transport import UdpMulticastBus
            from omniswarm_torch.swarm.node import DroneNode

            bus = UdpMulticastBus(port=args.port)
            node = DroneNode(self_id, bus, solver_params=cfg.solver,
                             frontend_params=cfg.frontend,
                             node_configs=cfg.nodes,
                             global_dim=cfg.frontend.global_desc_dim,
                             device=dev)
            estimator = node.estimator
        except OSError as e:
            print_line({"warn": f"udp unavailable: {e}"})

    loop = NodeLoop(estimator, port_kit(), self_id=self_id,
                    force_freq=cfg.solver.force_freq,
                    predict_freq=cfg.solver.predict_freq, node=node, bus=bus)
    # "ready" and the cadence record go to stderr: stdout carries the
    # protocol
    print(json.dumps({"type": "ready"}), file=sys.stderr, flush=True)
    run_lines(loop, sys.stdin)
    print(json.dumps({"type": "cadence", **loop.cadence()}),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
