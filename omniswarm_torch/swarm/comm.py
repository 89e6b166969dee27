"""Inter-drone communication layer: packets, the lossy bus and LoopNet.

A copy of ``omniswarm_tpu/swarm/comm.py`` (numpy only), so that the port
needs no JAX package at run time:

- ``KeyframeData``, a keyframe's shareable content (:42);
- ``encode_image`` / ``decode_image``, the JPEG wire format of the
  whole-descriptor mode (:59-83); they import OpenCV when called, and
  nothing on the demos' path calls them;
- the packets ``HeaderPacket``, ``LandmarkPacket``, ``WholeImgDescPacket``,
  ``LoopEdgePacket`` and ``InlierSetPacket`` with their wire sizes
  (:86-160);
- ``LossyBus``, the deterministic in-process multicast (:163-200): one
  ``np.random.default_rng(seed)`` draw per subscriber and message decides
  the drop, so a run's losses equal the reference's draw for draw;
- ``LoopNet``, the per-drone endpoint (:203-389): a keyframe is split into
  a header and one packet per valid landmark (int8 descriptors), the
  receiver reassembles by (drone, frame) with a ``recv_period`` timeout and
  counts each peer's receive rate.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

CHANNEL_IMG_DES = "SWARM_LOOP_IMG_DES"
CHANNEL_LOOP_CONN = "SWARM_LOOP_CONN"
CHANNEL_VIOKF_HEADER = "VIOKF_HEADER"
CHANNEL_VIOKF_LANDMARKS = "VIOKF_LANDMARKS"
CHANNEL_LOOP_INLIERS = "LOOP_INLIERS"


@dataclass
class KeyframeData:
    """A keyframe's shareable content (ImageDescriptor_t equivalent)."""

    drone_id: int
    frame_id: int
    t: float
    pose: np.ndarray               # (4,) VIO pose at keyframe
    global_desc: np.ndarray        # (G,) unit NetVLAD descriptor
    kp_xy: np.ndarray              # (K, 2) pixel coords
    landmarks_3d: np.ndarray       # (K, 3) body-frame 3-D points
    local_desc: np.ndarray         # (K, C) unit local descriptors
    valid: np.ndarray              # (K,) bool
    image: Optional[np.ndarray] = None  # (H, W) grayscale in [0,1], optional
    # match-only frame: receiver must not add it to its database
    # (prevent_adding_db, swarm_loop.cpp:155-158, loop_detector.cpp:89-94)
    prevent_adding_db: bool = False


def encode_image(img: np.ndarray, quality: int = 50) -> bytes:
    """JPEG-encode a grayscale [0,1] image for the wire.

    Mirrors the reference's LoopCam::encode_image
    (loop_cam.cpp:56-71 of the reference, IMWRITE_JPEG_QUALITY
    from the jpg_quality param, default 50 at swarm_loop.cpp:225).
    """
    import cv2
    u8 = np.clip(np.asarray(img, np.float32) * 255.0, 0, 255).astype(np.uint8)
    ok, buf = cv2.imencode(
        ".jpg", u8, [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    if not ok:
        raise RuntimeError("JPEG encode failed")
    return bytes(buf.tobytes())


def decode_image(data: bytes) -> np.ndarray:
    """Inverse of :func:`encode_image` — returns (H, W) float32 in [0,1]."""
    import cv2
    u8 = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    if u8 is None:
        raise RuntimeError("JPEG decode failed")
    return u8.astype(np.float32) / 255.0


@dataclass
class HeaderPacket:
    drone_id: int
    frame_id: int
    t: float
    pose: np.ndarray
    global_desc_q: np.ndarray      # float16 on the wire
    num_landmarks: int
    prevent_adding_db: bool = False

    def nbytes(self) -> int:
        return 32 + self.global_desc_q.size * 2


@dataclass
class LandmarkPacket:
    drone_id: int
    frame_id: int
    index: int
    xy: np.ndarray
    p3d: np.ndarray
    desc_q: np.ndarray             # int8
    desc_scale: float

    def nbytes(self) -> int:
        return 24 + self.desc_q.size


@dataclass
class WholeImgDescPacket:
    """A keyframe descriptor shipped as ONE packet, optionally with the
    JPEG-encoded image — the reference's ``send_whole_img_desc`` /
    ``send_img`` modes (loop_net.cpp:103-120: when either flag is set the
    full ImageDescriptor_t is published on SWARM_LOOP_IMG_DES instead of the
    header+landmark split)."""

    kf: KeyframeData
    jpeg: Optional[bytes] = None

    def nbytes(self) -> int:
        kf = self.kf
        n = (32 + kf.global_desc.size * 2 + kf.kp_xy.size * 4
             + kf.landmarks_3d.size * 4 + kf.local_desc.size
             + kf.valid.size)
        if self.jpeg is not None:
            n += len(self.jpeg)
        return n


@dataclass
class LoopEdgePacket:
    drone_a: int
    t_a: float
    drone_b: int
    t_b: float
    dpose: np.ndarray
    pos_std: float
    yaw_std: float
    # optional full 6-DoF relative pose (7,) [x y z qw qx qy qz]: the
    # reference's LoopEdge is 6-DoF and the back-end composes full-attitude
    # VIO when re-anchoring before its 4-DoF flatten
    # (swarm_localization_solver.cpp:1464-1553)
    dpose6: np.ndarray = None

    def nbytes(self) -> int:
        return 56 + (28 if self.dpose6 is not None else 0)


@dataclass
class InlierSetPacket:
    drone_a: int
    drone_b: int
    loop_keys: List[Tuple]         # hashable loop identifiers

    def nbytes(self) -> int:
        return 12 + 16 * len(self.loop_keys)


class LossyBus:
    """In-process multicast with loss, latency, and byte accounting."""

    def __init__(self, *, drop_rate: float = 0.0, latency: float = 0.0,
                 seed: int = 0):
        self.drop_rate = drop_rate
        self.latency = latency
        self._rng = np.random.default_rng(seed)
        self._subs: Dict[str, List[Tuple[int, Callable]]] = {}
        self._queue: List[Tuple[float, int, int, str, object]] = []
        self._seq = 0
        self.bytes_sent: Dict[str, int] = {}

    def subscribe(self, peer_id: int, channel: str, cb: Callable) -> None:
        self._subs.setdefault(channel, []).append((peer_id, cb))

    def publish(self, sender_id: int, channel: str, msg, t: float) -> None:
        nbytes = msg.nbytes() if hasattr(msg, "nbytes") else 64
        self.bytes_sent[channel] = self.bytes_sent.get(channel, 0) + nbytes
        for peer_id, _cb in self._subs.get(channel, []):
            if peer_id == sender_id:
                continue               # multicast loopback suppressed
            if self._rng.uniform() < self.drop_rate:
                continue
            self._seq += 1
            heapq.heappush(self._queue,
                           (t + self.latency, self._seq, peer_id, channel, msg))

    def step(self, t: float) -> int:
        """Deliver all messages due at time <= t; returns #delivered."""
        n = 0
        while self._queue and self._queue[0][0] <= t:
            _, _, peer_id, channel, msg = heapq.heappop(self._queue)
            for pid, cb in self._subs.get(channel, []):
                if pid == peer_id:
                    cb(msg)
                    n += 1
        return n


class LoopNet:
    """Per-drone endpoint: packetization, reassembly, rate accounting."""

    def __init__(self, bus, drone_id: int, *, recv_period: float = 1.0,
                 on_keyframe: Optional[Callable] = None,
                 on_loop: Optional[Callable] = None,
                 on_inliers: Optional[Callable] = None,
                 send_img: bool = False,
                 send_whole_img_desc: bool = False,
                 jpg_quality: int = 50):
        self.bus = bus
        self.drone_id = drone_id
        self.recv_period = recv_period
        self.on_keyframe = on_keyframe
        self.on_loop = on_loop
        self.on_inliers = on_inliers
        self.send_img = send_img
        self.send_whole_img_desc = send_whole_img_desc
        self.jpg_quality = jpg_quality
        # sender-side dedup set, FIFO-bounded: the reference's sent_message
        # grows forever over an hours-long flight (loop_net.cpp:221-237);
        # capping at max_sent_keys keeps memory flat with identical behavior
        # for any frame still inside the rebroadcast horizon.
        self.max_sent_keys = 8192
        self.sent: set = set()
        self._sent_order: deque = deque()
        self.blacklist: set = set()
        self._partial: Dict[Tuple[int, int], Dict] = {}
        self.recv_packets: Dict[int, int] = {}   # per-drone packet counts
        self.recv_expected: Dict[int, int] = {}
        bus.subscribe(drone_id, CHANNEL_IMG_DES, self._on_whole_img_desc)
        bus.subscribe(drone_id, CHANNEL_VIOKF_HEADER, self._on_header)
        bus.subscribe(drone_id, CHANNEL_VIOKF_LANDMARKS, self._on_landmark)
        bus.subscribe(drone_id, CHANNEL_LOOP_CONN, self._on_loop_edge)
        bus.subscribe(drone_id, CHANNEL_LOOP_INLIERS, self._on_inlier_set)

    # ---------------- send ----------------
    def broadcast_keyframe(self, kf: KeyframeData, t: float) -> None:
        key = (kf.drone_id, kf.frame_id)
        if key in self.sent:
            return                     # sender-side dedup (loop_net sent_message)
        self.sent.add(key)
        self._sent_order.append(key)
        while len(self._sent_order) > self.max_sent_keys:
            self.sent.discard(self._sent_order.popleft())
        if self.send_img or self.send_whole_img_desc:
            # Whole-descriptor mode (loop_net.cpp:103-120): one packet on
            # SWARM_LOOP_IMG_DES, with the JPEG image iff send_img.
            jpeg = None
            if self.send_img and kf.image is not None:
                jpeg = encode_image(kf.image, self.jpg_quality)
            self.bus.publish(self.drone_id, CHANNEL_IMG_DES,
                             WholeImgDescPacket(kf=kf, jpeg=jpeg), t)
            return
        k_valid = np.flatnonzero(np.asarray(kf.valid))
        header = HeaderPacket(
            drone_id=kf.drone_id, frame_id=kf.frame_id, t=kf.t,
            pose=np.asarray(kf.pose, np.float32),
            global_desc_q=np.asarray(kf.global_desc, np.float16),
            num_landmarks=len(k_valid),
            prevent_adding_db=kf.prevent_adding_db)
        self.bus.publish(self.drone_id, CHANNEL_VIOKF_HEADER, header, t)
        for i in k_valid:
            d = np.asarray(kf.local_desc[i], np.float32)
            scale = float(np.max(np.abs(d))) or 1.0
            self.bus.publish(
                self.drone_id, CHANNEL_VIOKF_LANDMARKS,
                LandmarkPacket(
                    drone_id=kf.drone_id, frame_id=kf.frame_id, index=int(i),
                    xy=np.asarray(kf.kp_xy[i], np.float32),
                    p3d=np.asarray(kf.landmarks_3d[i], np.float32),
                    desc_q=np.clip(np.round(d / scale * 127), -127,
                                   127).astype(np.int8),
                    desc_scale=scale), t)

    def broadcast_loop_edge(self, edge: LoopEdgePacket, t: float) -> None:
        self.bus.publish(self.drone_id, CHANNEL_LOOP_CONN, edge, t)

    def broadcast_inlier_set(self, pkt: InlierSetPacket, t: float) -> None:
        self.bus.publish(self.drone_id, CHANNEL_LOOP_INLIERS, pkt, t)

    # ---------------- receive ----------------
    def _on_whole_img_desc(self, pkt: WholeImgDescPacket) -> None:
        if pkt.kf.drone_id in self.blacklist:
            return
        self.recv_packets[pkt.kf.drone_id] = \
            self.recv_packets.get(pkt.kf.drone_id, 0) + 1
        self.recv_expected[pkt.kf.drone_id] = \
            self.recv_expected.get(pkt.kf.drone_id, 0) + 1
        kf = pkt.kf
        if pkt.jpeg is not None:
            kf = KeyframeData(
                drone_id=kf.drone_id, frame_id=kf.frame_id, t=kf.t,
                pose=kf.pose, global_desc=kf.global_desc, kp_xy=kf.kp_xy,
                landmarks_3d=kf.landmarks_3d, local_desc=kf.local_desc,
                valid=kf.valid, image=decode_image(pkt.jpeg),
                prevent_adding_db=kf.prevent_adding_db)
        if self.on_keyframe is not None:
            self.on_keyframe(kf)

    def _on_header(self, pkt: HeaderPacket) -> None:
        if pkt.drone_id in self.blacklist:
            return
        key = (pkt.drone_id, pkt.frame_id)
        st = self._partial.setdefault(key, {"landmarks": {}, "header": None,
                                            "first_seen": None})
        st["header"] = pkt
        self.recv_packets[pkt.drone_id] = \
            self.recv_packets.get(pkt.drone_id, 0) + 1
        self.recv_expected[pkt.drone_id] = \
            self.recv_expected.get(pkt.drone_id, 0) + 1 + pkt.num_landmarks

    def _on_landmark(self, pkt: LandmarkPacket) -> None:
        if pkt.drone_id in self.blacklist:
            return
        key = (pkt.drone_id, pkt.frame_id)
        st = self._partial.setdefault(key, {"landmarks": {}, "header": None,
                                            "first_seen": None})
        st["landmarks"][pkt.index] = pkt
        self.recv_packets[pkt.drone_id] = \
            self.recv_packets.get(pkt.drone_id, 0) + 1

    def _on_loop_edge(self, pkt: LoopEdgePacket) -> None:
        if self.on_loop is not None:
            self.on_loop(pkt)

    def _on_inlier_set(self, pkt: InlierSetPacket) -> None:
        if self.on_inliers is not None:
            self.on_inliers(pkt)

    def scan_recv_packets(self, t: float) -> int:
        """Finalize reassembled keyframes (timeout-based, loop_net:223-296)."""
        done = []
        for key, st in self._partial.items():
            if st["first_seen"] is None:
                st["first_seen"] = t
            hdr = st["header"]
            complete = (hdr is not None
                        and len(st["landmarks"]) >= hdr.num_landmarks)
            expired = t - st["first_seen"] >= self.recv_period
            if complete or (expired and hdr is not None):
                done.append(key)
        n = 0
        for key in done:
            st = self._partial.pop(key)
            kf = self._assemble(st)
            if kf is not None and self.on_keyframe is not None:
                self.on_keyframe(kf)
                n += 1
        # drop headerless expired partials
        stale = [k for k, st in self._partial.items()
                 if st["first_seen"] is not None
                 and t - st["first_seen"] > 3 * self.recv_period]
        for k in stale:
            del self._partial[k]
        return n

    def _assemble(self, st) -> Optional[KeyframeData]:
        hdr: HeaderPacket = st["header"]
        lms = st["landmarks"]
        K = hdr.num_landmarks
        if K == 0 and not lms:
            return None
        kmax = max([K] + [i + 1 for i in lms])
        xy = np.zeros((kmax, 2), np.float32)
        p3d = np.zeros((kmax, 3), np.float32)
        dim = next(iter(lms.values())).desc_q.size if lms else 0
        desc = np.zeros((kmax, dim), np.float32)
        valid = np.zeros(kmax, bool)
        for i, pkt in lms.items():
            xy[i] = pkt.xy
            p3d[i] = pkt.p3d
            desc[i] = pkt.desc_q.astype(np.float32) / 127.0 * pkt.desc_scale
            valid[i] = True
        norms = np.linalg.norm(desc, axis=1, keepdims=True)
        desc = np.where(norms > 1e-8, desc / np.maximum(norms, 1e-8), desc)
        return KeyframeData(
            drone_id=hdr.drone_id, frame_id=hdr.frame_id, t=hdr.t,
            pose=hdr.pose, global_desc=hdr.global_desc_q.astype(np.float32),
            kp_xy=xy, landmarks_3d=p3d, local_desc=desc, valid=valid,
            prevent_adding_db=hdr.prevent_adding_db)

    def receive_rate(self, drone_id: int) -> float:
        exp = self.recv_expected.get(drone_id, 0)
        if exp == 0:
            return 0.0
        return self.recv_packets.get(drone_id, 0) / exp
