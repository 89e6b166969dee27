"""UWB/narrowband bridge: swarm frames, clock sync and fixed-point packets.

A copy of ``omniswarm_tpu/swarm/proxy.py`` (numpy and ``struct`` only), the
localization_proxy equivalent: each UWB tick creates a swarm frame of self
odometry and measured distances, and frames wait in a bounded queue so late
remote odometry can merge into them (``LocalProxy``); ``TimeSync`` maps the
radio's clock to the host's; ``FusedStatePacket``, ``NodeDetectedPacket``
and ``NodeRealtimeInfo`` are the fixed-point radio payloads (pos float,
vel x100, rpy x1000, distances in mm as uint16, 0xFFFF invalid), framed by
one type byte (``frame_packet`` / ``parse_packet``). Every encoder gives the
reference's bytes.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

MAX_DRONES = 10
INVALID_DISTANCE = 0xFFFF

# ts_ms i32 | drone u8 | odom_ok u8 | pos 3f | vel 3h (cm/s) | rpy 3h (mrad)
# | dis 10H (mm)
_RT_FMT = struct.Struct("<iBB3f3h3h10H")


@dataclass
class NodeRealtimeInfo:
    t: float
    drone_id: int
    odometry_available: bool
    pos: np.ndarray               # (3,) float
    vel: np.ndarray               # (3,)
    rpy: np.ndarray               # (3,)
    distances: Dict[int, float]   # peer -> meters

    @property
    def pose4(self) -> np.ndarray:
        return np.concatenate([self.pos, self.rpy[2:3]])


def encode_realtime_info(info: NodeRealtimeInfo) -> bytes:
    dis = [INVALID_DISTANCE] * MAX_DRONES
    for peer, d in info.distances.items():
        if 0 <= peer < MAX_DRONES and d >= 0:
            dis[peer] = min(int(d * 1000), 0xFFFE)
    return _RT_FMT.pack(
        int(info.t * 1000), info.drone_id, int(info.odometry_available),
        *[float(x) for x in info.pos],
        *[int(np.clip(v * 100, -32768, 32767)) for v in info.vel],
        *[int(np.clip(a * 1000, -32768, 32767)) for a in info.rpy],
        *dis)


def decode_realtime_info(buf: bytes) -> NodeRealtimeInfo:
    vals = _RT_FMT.unpack(buf)
    ts_ms, drone_id, odom_ok = vals[0], vals[1], vals[2]
    pos = np.asarray(vals[3:6], float)
    vel = np.asarray(vals[6:9], float) / 100.0
    rpy = np.asarray(vals[9:12], float) / 1000.0
    dis_raw = vals[12:22]
    distances = {i: d / 1000.0 for i, d in enumerate(dis_raw)
                 if d != INVALID_DISTANCE}
    return NodeRealtimeInfo(
        t=ts_ms / 1000.0, drone_id=drone_id, odometry_available=bool(odom_ok),
        pos=pos, vel=vel, rpy=rpy, distances=distances)


@dataclass
class SwarmFrame:
    t: float
    # drone -> (pose4, vel) — self entry plus merged remote entries
    nodes: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    ranges: Dict[Tuple[int, int], float] = field(default_factory=dict)


class LocalProxy:
    """Swarm-frame assembly with a merge queue for late remote odometry."""

    def __init__(self, self_id: int, *, queue_size: int = 10,
                 match_tolerance: float = 0.1,
                 on_frame: Optional[Callable[[SwarmFrame], None]] = None,
                 on_detection: Optional[Callable] = None,
                 on_fused: Optional[Callable] = None):
        self.self_id = self_id
        self.queue_size = queue_size
        self.match_tolerance = match_tolerance
        self.on_frame = on_frame
        # callbacks for the non-frame radio families: visual detections
        # relayed over UWB (send_node_detected/parse_node_detected,
        # localization_proxy.cpp:204-235) and peer fused-state downlinks
        self.on_detection = on_detection
        self.on_fused = on_fused
        self.queue: List[SwarmFrame] = []
        self.self_odom: Optional[Tuple[float, np.ndarray, np.ndarray]] = None

    def on_self_odometry(self, t: float, pose4: np.ndarray,
                         vel: np.ndarray) -> None:
        self.self_odom = (t, np.asarray(pose4, float), np.asarray(vel, float))

    def on_uwb_tick(self, t: float, distances: Dict[int, float]) -> bytes:
        """A UWB ranging cycle: create a frame, return the broadcast packet.

        Mirrors on_remote_uwb_info → create_swarm_frame_from_uwb.
        """
        sf = SwarmFrame(t=t)
        if self.self_odom is not None:
            _, pose, vel = self.self_odom
            sf.nodes[self.self_id] = (pose.copy(), vel.copy())
        for peer, d in distances.items():
            if d >= 0:
                sf.ranges[(self.self_id, peer)] = float(d)
        self.queue.append(sf)
        released = self.queue[: max(0, len(self.queue) - self.queue_size)]
        self.queue = self.queue[len(released):]
        if self.on_frame:
            for sf_out in released:
                self.on_frame(sf_out)

        pose = self.self_odom[1] if self.self_odom else np.zeros(4)
        vel = self.self_odom[2] if self.self_odom else np.zeros(3)
        info = NodeRealtimeInfo(
            t=t, drone_id=self.self_id,
            odometry_available=self.self_odom is not None,
            pos=pose[:3], vel=vel, rpy=np.asarray([0.0, 0.0, pose[3]]),
            distances=distances)
        return encode_realtime_info(info)

    def on_remote_packet(self, buf: bytes) -> bool:
        """Merge a peer's fixed-point odometry+ranges into a queued frame."""
        info = decode_realtime_info(buf)
        if info.drone_id == self.self_id:
            return False
        best, best_dt = None, self.match_tolerance
        for sf in self.queue:
            dt = abs(sf.t - info.t)
            if dt <= best_dt:
                best, best_dt = sf, dt
        if best is None:
            return False
        if info.odometry_available:
            best.nodes[info.drone_id] = (info.pose4,
                                         info.vel)
        for peer, d in info.distances.items():
            best.ranges[(info.drone_id, peer)] = d
        return True

    def broadcast_detection(self, det: "NodeDetectedPacket") -> bytes:
        """Frame a visual detection for the narrowband radio."""
        return frame_packet(PACKET_DETECTED, encode_node_detected(det))

    def framed_uwb_tick(self, t: float,
                        distances: Dict[int, float]) -> bytes:
        """on_uwb_tick with the type-byte radio framing applied."""
        return frame_packet(PACKET_REALTIME, self.on_uwb_tick(t, distances))

    def on_radio_packet(self, buf: bytes) -> bool:
        """Dispatch one framed narrowband datagram by its type byte."""
        ptype, payload = parse_packet(buf)
        if ptype == PACKET_REALTIME:
            return self.on_remote_packet(payload)
        if ptype == PACKET_DETECTED:
            det = decode_node_detected(payload)
            if det.source_id != self.self_id and self.on_detection:
                self.on_detection(det)
                return True
            return False
        if ptype == PACKET_FUSED:
            fs = decode_fused_state(payload)
            if fs.ref_drone != self.self_id and self.on_fused:
                self.on_fused(fs)
                return True
            return False
        return False

    def flush(self) -> List[SwarmFrame]:
        """Release all queued frames (end of session / timer flush)."""
        out, self.queue = self.queue, []
        if self.on_frame:
            for sf in out:
                self.on_frame(sf)
        return out

    def predict_frame(self, t: float) -> Optional[SwarmFrame]:
        """Velocity-extrapolated high-rate frame (predict_nf :586-598)."""
        if self.self_odom is None:
            return None
        t0, pose, vel = self.self_odom
        dt = t - t0
        pred = pose.copy()
        pred[:3] = pose[:3] + vel * dt
        sf = SwarmFrame(t=t)
        sf.nodes[self.self_id] = (pred, vel.copy())
        return sf


class TimeSync:
    """Radio (LPS) ↔ host clock mapping.

    The reference maps UWB local-positioning-system time to ROS time via a
    TimeReference subscription (LPS2ROSTIME/ROSTIME2LPS,
    localization_proxy.cpp:808-816). Here: an online least-squares linear
    fit lps → host over a sliding sample window, robust to offset drift.
    """

    def __init__(self, window: int = 64):
        self.window = window
        self._samples: List[Tuple[float, float]] = []
        self._a = 1.0     # host ≈ a * lps + b
        self._b = 0.0

    def add_reference(self, lps_time: float, host_time: float) -> None:
        self._samples.append((lps_time, host_time))
        if len(self._samples) > self.window:
            self._samples.pop(0)
        if len(self._samples) >= 2:
            x = np.asarray([s[0] for s in self._samples])
            y = np.asarray([s[1] for s in self._samples])
            xm, ym = x.mean(), y.mean()
            denom = float(np.sum((x - xm) ** 2))
            self._a = float(np.sum((x - xm) * (y - ym)) / denom) \
                if denom > 1e-12 else 1.0
            self._b = float(ym - self._a * xm)
        elif self._samples:
            self._b = self._samples[0][1] - self._samples[0][0]

    def lps_to_host(self, lps_time: float) -> float:
        return self._a * lps_time + self._b

    def host_to_lps(self, host_time: float) -> float:
        return (host_time - self._b) / self._a


# --------------------------------------------------------------------------
# Fused-state downlinks (ground station / peers)
# --------------------------------------------------------------------------

# drone u8 | ref u8 | ts_ms i32 | rel pos 3h (mm) | rel yaw h (mrad)
_FUSED_FMT = struct.Struct("<BBi3hh")


@dataclass
class FusedStatePacket:
    """Compact fused relative state: drone's pose in ref_drone's frame.

    Counterpart of node_relative_fused / node_based_fused downlinks
    (localization_proxy.cpp:438-553), throttled round-robin by send freq.
    """

    drone_id: int
    ref_drone: int
    t: float
    rel_pose: np.ndarray    # (4,)


def encode_fused_state(p: FusedStatePacket) -> bytes:
    mm = np.clip(np.asarray(p.rel_pose[:3]) * 1000, -32768, 32767)
    return _FUSED_FMT.pack(
        p.drone_id, p.ref_drone, int(p.t * 1000),
        int(mm[0]), int(mm[1]), int(mm[2]),
        int(np.clip(p.rel_pose[3] * 1000, -32768, 32767)))


def decode_fused_state(buf: bytes) -> FusedStatePacket:
    d, r, ts_ms, x, y, z, yaw = _FUSED_FMT.unpack(buf)
    return FusedStatePacket(
        drone_id=d, ref_drone=r, t=ts_ms / 1000.0,
        rel_pose=np.asarray([x / 1000.0, y / 1000.0, z / 1000.0,
                             yaw / 1000.0]))


# --------------------------------------------------------------------------
# Radio framing: one type byte in front of each fixed-point payload, so a
# single narrowband channel carries all packet families (the reference
# multiplexes MAVLink message ids over the UWB radio the same way).
# --------------------------------------------------------------------------

PACKET_REALTIME = 0x01       # NodeRealtimeInfo (odometry + ranges)
PACKET_FUSED = 0x02          # FusedStatePacket downlink
PACKET_DETECTED = 0x03       # NodeDetectedPacket visual detection


def frame_packet(ptype: int, payload: bytes) -> bytes:
    return bytes([ptype]) + payload


def parse_packet(buf: bytes) -> Tuple[int, bytes]:
    return buf[0], buf[1:]


# --------------------------------------------------------------------------
# Visual detection narrowband packet
# --------------------------------------------------------------------------

# ts_ms i32 | source u8 | remote u16 | det_id i32 | rel pos 3h (cm)
# | rel yaw h (mrad) | stds 4H (pos mm, yaw mrad)
_DET_FMT = struct.Struct("<iBH i3hh4H")


@dataclass
class NodeDetectedPacket:
    """Fixed-point visual drone-detection relay for the narrowband radio.

    Counterpart of send_node_detected/parse_node_detected
    (localization_proxy.cpp:204-235): a no-WiFi swarm shares visual
    detections over UWB. The reference packs ts, ids, xyz+yaw floats and 4
    covariance diagonals; here position is cm int16 (±327 m), yaw mrad, and
    the std diagonals are mm/mrad uint16 — 27 bytes vs the reference's ~40.
    ``remote_drone_id`` may be an anonymous id (>=1000, solver.cpp:898-916).
    """

    t: float
    source_id: int                 # detecting drone
    remote_drone_id: int           # detected drone (possibly anonymous)
    detection_id: int
    rel_pos: np.ndarray            # (3,) meters, detector frame
    rel_yaw: float                 # rad
    pos_std: np.ndarray            # (3,) meters (sqrt of cov diagonal)
    yaw_std: float                 # rad


def encode_node_detected(p: NodeDetectedPacket) -> bytes:
    cm = np.clip(np.asarray(p.rel_pos) * 100, -32768, 32767)
    std_mm = np.clip(np.asarray(p.pos_std) * 1000, 0, 0xFFFF)
    return _DET_FMT.pack(
        int(p.t * 1000), p.source_id, p.remote_drone_id, p.detection_id,
        int(cm[0]), int(cm[1]), int(cm[2]),
        int(np.clip(p.rel_yaw * 1000, -32768, 32767)),
        int(std_mm[0]), int(std_mm[1]), int(std_mm[2]),
        int(np.clip(p.yaw_std * 1000, 0, 0xFFFF)))


def decode_node_detected(buf: bytes) -> NodeDetectedPacket:
    (ts_ms, src, rem, det_id, x, y, z, yaw,
     sx, sy, sz, syaw) = _DET_FMT.unpack(buf)
    return NodeDetectedPacket(
        t=ts_ms / 1000.0, source_id=src, remote_drone_id=rem,
        detection_id=det_id,
        rel_pos=np.asarray([x, y, z], float) / 100.0,
        rel_yaw=yaw / 1000.0,
        pos_std=np.asarray([sx, sy, sz], float) / 1000.0,
        yaw_std=syaw / 1000.0)


class FusedDownlink:
    """Round-robin throttled broadcaster of fused relative states.

    Mirrors the reference's send_swarm_fused_relative round-robin under
    send_rel_fused_freq (localization_proxy.cpp:438-500): each call emits at
    most one drone's packet, cycling through the swarm, rate-limited.
    """

    def __init__(self, self_id: int, send_freq: float = 10.0):
        self.self_id = self_id
        self.period = 1.0 / send_freq
        self._last_send = -np.inf
        self._rr = 0

    def tick(self, t: float, relative_states: Dict[int, np.ndarray]
             ) -> Optional[bytes]:
        """relative_states: drone -> (4,) pose in self frame."""
        if t - self._last_send < self.period or not relative_states:
            return None
        ids = sorted(relative_states)
        drone = ids[self._rr % len(ids)]
        self._rr += 1
        self._last_send = t
        return encode_fused_state(FusedStatePacket(
            drone_id=drone, ref_drone=self.self_id, t=t,
            rel_pose=relative_states[drone]))
