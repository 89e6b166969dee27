"""The port's UDP multicast bus over loopback, and drones as processes.

Mirrors ``tests/test_udp_transport.py`` (a loop edge and a keyframe through
the port's ``LoopNet`` over a real socket; skipped when the host refuses
the socket, as the reference's are) and, marked ``slow`` as the
reference's is, ``tests/test_multiprocess.py`` through
``omniswarm_torch.runtime.drone_process``. The port's tests use ports of
their own (17767, 17901), so they never receive the reference tests'
datagrams when both run at once.
"""
import time

import numpy as np
import pytest
import torch

from omniswarm_torch.runtime import udp_transport as tudp
from omniswarm_torch.swarm.comm import KeyframeData, LoopEdgePacket, LoopNet

torch.set_num_threads(1)
PORT = 17767


def make_bus():
    try:
        return tudp.UdpMulticastBus(port=PORT)
    except OSError as e:
        pytest.skip(f"multicast unavailable on this host: {e}")


def make_kf(drone=1, frame=0, K=20, seed=0):
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(K, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return KeyframeData(
        drone_id=drone, frame_id=frame, t=float(frame),
        pose=np.zeros(4, np.float32),
        global_desc=rng.normal(size=256).astype(np.float32),
        kp_xy=rng.uniform(0, 100, size=(K, 2)).astype(np.float32),
        landmarks_3d=rng.normal(size=(K, 3)).astype(np.float32),
        local_desc=desc, valid=np.ones(K, bool))


def test_wire_format_is_the_references():
    from omniswarm_tpu.runtime import udp_transport as judp

    assert tudp._HDR.format == judp._HDR.format == "!IHH"
    assert tudp._CHANNELS == judp._CHANNELS
    assert (tudp.DEFAULT_GROUP, tudp.DEFAULT_PORT) == \
        (judp.DEFAULT_GROUP, judp.DEFAULT_PORT) == ("224.0.0.251", 7667)


def test_udp_loop_edge_roundtrip():
    bus = make_bus()
    edges = []
    net1 = LoopNet(bus, 1)
    LoopNet(bus, 2, on_loop=edges.append)
    pkt = LoopEdgePacket(drone_a=1, t_a=0.5, drone_b=2, t_b=1.5,
                         dpose=np.arange(4.0), pos_std=0.05, yaw_std=0.02)
    net1.broadcast_loop_edge(pkt, 0.0)
    deadline = time.time() + 2.0
    while time.time() < deadline and not edges:
        bus.step()
        time.sleep(0.01)
    bus.close()
    assert edges, "datagram not delivered over loopback multicast"
    got = edges[0]
    assert got.drone_a == 1 and got.drone_b == 2
    np.testing.assert_allclose(got.dpose, np.arange(4.0))
    assert bus.bytes_sent["SWARM_LOOP_CONN"] > tudp._HDR.size


def test_udp_keyframe_roundtrip():
    bus = make_bus()
    received = []
    net1 = LoopNet(bus, 1)
    net2 = LoopNet(bus, 2, on_keyframe=received.append)
    net1.broadcast_keyframe(make_kf(drone=1, frame=9, K=30), 0.0)
    deadline = time.time() + 2.0
    while time.time() < deadline:
        bus.step()
        net2.scan_recv_packets(time.time())
        if received:
            break
        time.sleep(0.01)
    bus.close()
    assert received and received[0].frame_id == 9
    assert received[0].valid.sum() == 30


@pytest.mark.slow
def test_two_process_swarm(tmp_path):
    from omniswarm_torch.node_entry import process_swarm

    res = process_swarm(tmp_path, port=17901, device="cpu", timeout_s=900)
    rows = res["processes"]
    for row in rows:
        assert row["returncode"] == 0, row["tail"]
        if row["solved"]:
            assert row["relative_ate"] < 0.3, row
    # at least one process solved, and loop edges crossed the processes
    assert any(row["solved"] for row in rows)
    assert sum(row["loops_found"] + row["loops_received"]
               for row in rows if row["solved"]) > 0
