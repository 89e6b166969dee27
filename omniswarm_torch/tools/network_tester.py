"""Swarm network tester: dummy keyframes at a fixed rate over UDP multicast,
and the receive rate of each peer.

    python -m omniswarm_torch.tools.network_tester --drone-id 0
        [--rate 1.0] [--duration 30] [--port 7667]

Counterpart of ``tools/network_tester.py`` (the loop_network_tester
equivalent): broadcasts a dummy 200-landmark keyframe every 1 / ``--rate``
seconds through ``swarm.comm.LoopNet`` over ``runtime/udp_transport.py``
and reports, per peer, the keyframes received and ``LoopNet``'s receive
rate (packets received over packets expected). It runs on the host and
takes no device. ``run`` returns the counts.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from omniswarm_torch.runtime.udp_transport import UdpMulticastBus
from omniswarm_torch.swarm.comm import KeyframeData, LoopNet


def dummy_keyframe(drone_id: int, frame_id: int, n_landmarks: int = 200):
    rng = np.random.default_rng(frame_id)
    desc = rng.normal(size=(n_landmarks, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return KeyframeData(
        drone_id=drone_id, frame_id=frame_id, t=time.time(),
        pose=np.zeros(4, np.float32),
        global_desc=rng.normal(size=4096).astype(np.float32),
        kp_xy=rng.uniform(0, 400, size=(n_landmarks, 2)).astype(np.float32),
        landmarks_3d=rng.normal(size=(n_landmarks, 3)).astype(np.float32),
        local_desc=desc, valid=np.ones(n_landmarks, bool))


def run(drone_id: int, rate: float = 1.0, duration: float = 30.0,
        port: int = 7667) -> dict:
    """Send and listen for ``duration`` seconds; returns {"sent": frames,
    "received": keyframes from peers, "peers": {drone: {"packets": n,
    "receive_rate": r}}}."""
    bus = UdpMulticastBus(port=port)
    received = []
    net = LoopNet(bus, drone_id, on_keyframe=received.append)

    t0 = time.time()
    frame = 0
    next_send = t0
    try:
        while time.time() - t0 < duration:
            now = time.time()
            if now >= next_send:
                net.broadcast_keyframe(dummy_keyframe(drone_id, frame), now)
                frame += 1
                next_send += 1.0 / rate
            bus.step(now)
            net.scan_recv_packets(now)
            time.sleep(0.01)
    finally:
        bus.close()

    print(f"sent {frame} keyframes; received {len(received)} from peers",
          flush=True)
    peers = {}
    for drone in sorted(net.recv_expected):
        peers[drone] = {"packets": net.recv_packets.get(drone, 0),
                        "receive_rate": net.receive_rate(drone)}
        print(f"  drone {drone}: receive rate "
              f"{peers[drone]['receive_rate'] * 100:.1f}% "
              f"({peers[drone]['packets']} packets)", flush=True)
    return {"sent": frame, "received": len(received), "peers": peers}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.network_tester",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--drone-id", type=int, required=True)
    ap.add_argument("--rate", type=float, default=1.0, help="keyframes/s")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--port", type=int, default=7667)
    args = ap.parse_args(argv)
    return run(args.drone_id, args.rate, args.duration, args.port)


if __name__ == "__main__":
    main()
