"""A real UDP multicast bus with the interface of ``swarm.comm.LossyBus``.

Counterpart of ``omniswarm_tpu/runtime/udp_transport.py``. Wire format of
a datagram: the ``!IHH`` header (sender id, channel id, payload length),
then the pickled payload (the packet dataclasses of ``swarm.comm``). The
channel ids are the positions in ``_CHANNELS``, the reference's order.
The pickle names the packet classes' module, so a port process and a
reference process cannot read each other's datagrams.

The default endpoint is the reference's LCM URL
``udpm://224.0.0.251:7667`` (loop_net.cpp:4-17). The socket is
``csrc/udp_multicast.cpp``, built by ``runtime.native``; a failed build
raises, and a socket the host refuses raises ``OSError``.
"""
from __future__ import annotations

import ctypes
import pickle
import struct
from typing import Callable, Dict, List, Tuple

from omniswarm_torch.runtime.native import udp_library

DEFAULT_GROUP = "224.0.0.251"
DEFAULT_PORT = 7667
_HDR = struct.Struct("!IHH")
_CHANNELS: List[str] = [
    "SWARM_LOOP_IMG_DES", "SWARM_LOOP_CONN", "VIOKF_HEADER",
    "VIOKF_LANDMARKS", "LOOP_INLIERS",
]


class UdpMulticastBus:
    """LossyBus-compatible transport over real multicast datagrams.

    Each process makes one bus; ``step()`` drains the socket and hands each
    message to every subscriber of its channel except the sender. Loss and
    latency are the network's.
    """

    def __init__(self, group: str = DEFAULT_GROUP, port: int = DEFAULT_PORT,
                 ttl: int = 1, loopback: bool = True):
        self._lib = udp_library()
        self.group = group.encode()
        self.port = port
        fd = self._lib.umc_open(self.group, port, ttl, int(loopback))
        if fd < 0:
            raise OSError(-fd, "umc_open failed")
        self._fd = fd
        self._subs: Dict[str, List[Tuple[int, Callable]]] = {}
        self._buf = ctypes.create_string_buffer(65536)
        self.bytes_sent: Dict[str, int] = {}

    def subscribe(self, peer_id: int, channel: str, cb: Callable) -> None:
        self._subs.setdefault(channel, []).append((peer_id, cb))

    def publish(self, sender_id: int, channel: str, msg,
                t: float = 0.0) -> None:
        payload = pickle.dumps(msg, protocol=4)
        cid = _CHANNELS.index(channel) if channel in _CHANNELS else 0xFFFF
        pkt = _HDR.pack(sender_id, cid, min(len(payload), 0xFFFF)) + payload
        n = self._lib.umc_send(self._fd, self.group, self.port, pkt, len(pkt))
        if n < 0:
            raise OSError(-n, "umc_send failed")
        self.bytes_sent[channel] = self.bytes_sent.get(channel, 0) + len(pkt)

    def step(self, t: float = 0.0) -> int:
        """Deliver every datagram waiting on the socket; returns the number
        of deliveries."""
        delivered = 0
        while True:
            n = self._lib.umc_recv(self._fd, self._buf, 65536)
            if n == 0:
                break
            if n < 0:
                raise OSError(-n, "umc_recv failed")
            raw = self._buf.raw[:n]
            sender_id, cid, _plen = _HDR.unpack_from(raw)
            channel = _CHANNELS[cid] if cid < len(_CHANNELS) else "?"
            msg = pickle.loads(raw[_HDR.size:])
            for pid, cb in self._subs.get(channel, []):
                if pid != sender_id:
                    cb(msg)
                    delivered += 1
        return delivered

    def close(self) -> None:
        self._lib.umc_close(self._fd)
