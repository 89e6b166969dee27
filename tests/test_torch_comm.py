"""The port's comm layer and radio proxy against the JAX package's copies.

Two kinds of check: every test of ``tests/test_comm.py`` and
``tests/test_proxy.py`` runs once more with the port's classes bound in
place of the reference's; and the wire formats are held byte for byte: the
proxy's fixed-point packets both ways, the packets LoopNet publishes for a
keyframe (with their ``nbytes``), the LossyBus drop and delivery stream, and
the JPEG of the whole-descriptor mode.
"""
import heapq
import sys
from pathlib import Path

import numpy as np
import pytest

import omniswarm_torch.swarm.comm as tcomm
import omniswarm_torch.swarm.proxy as tproxy
import omniswarm_tpu.swarm.comm as jcomm
import omniswarm_tpu.swarm.proxy as jproxy

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_comm as ref_comm_tests  # noqa: E402
import test_proxy as ref_proxy_tests  # noqa: E402


def _cases(mod):
    return sorted(n for n in dir(mod) if n.startswith("test_"))


def _rebind(monkeypatch, tests_mod, port_mod):
    """Point every name the reference test module took from the reference
    package at the port's object of the same name."""
    for name in dir(tests_mod):
        if hasattr(port_mod, name) and getattr(tests_mod, name) is getattr(
                sys.modules[port_mod.__name__.replace("omniswarm_torch",
                                                      "omniswarm_tpu")],
                name, None):
            monkeypatch.setattr(tests_mod, name, getattr(port_mod, name))


@pytest.mark.parametrize("case", _cases(ref_comm_tests))
def test_comm_cases_on_port(case, monkeypatch):
    _rebind(monkeypatch, ref_comm_tests, tcomm)
    assert ref_comm_tests.LoopNet is tcomm.LoopNet
    getattr(ref_comm_tests, case)()


@pytest.mark.parametrize("case", _cases(ref_proxy_tests))
def test_proxy_cases_on_port(case, monkeypatch):
    _rebind(monkeypatch, ref_proxy_tests, tproxy)
    getattr(ref_proxy_tests, case)()


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

def _realtime(mod, rng, i):
    return mod.NodeRealtimeInfo(
        t=1.234 * i, drone_id=i % 5, odometry_available=bool(i % 2),
        pos=rng.normal(size=3), vel=rng.normal(size=3),
        rpy=rng.normal(size=3) * 0.5,
        distances={j: float(rng.uniform(0, 20)) for j in range(4) if j != i})


def test_proxy_packets_bytes_equal(rng):
    for i in range(8):
        seed = int(rng.integers(1 << 30))
        a = _realtime(jproxy, np.random.default_rng(seed), i)
        b = _realtime(tproxy, np.random.default_rng(seed), i)
        wire = jproxy.encode_realtime_info(a)
        assert tproxy.encode_realtime_info(b) == wire
        da, db = jproxy.decode_realtime_info(wire), \
            tproxy.decode_realtime_info(wire)
        assert da.distances == db.distances and da.t == db.t
        np.testing.assert_array_equal(da.pose4, db.pose4)

        fs = dict(drone_id=i, ref_drone=(i + 1) % 5, t=0.5 * i,
                  rel_pose=rng.normal(size=4))
        wire = jproxy.encode_fused_state(jproxy.FusedStatePacket(**fs))
        assert tproxy.encode_fused_state(tproxy.FusedStatePacket(**fs)) \
            == wire
        np.testing.assert_array_equal(
            tproxy.decode_fused_state(wire).rel_pose,
            jproxy.decode_fused_state(wire).rel_pose)

        det = dict(t=0.1 * i, source_id=i, remote_drone_id=1000 + i,
                   detection_id=7 * i, rel_pos=rng.normal(size=3),
                   rel_yaw=float(rng.normal()), pos_std=rng.uniform(0, 1, 3),
                   yaw_std=float(rng.uniform(0, 1)))
        wire = jproxy.frame_packet(
            jproxy.PACKET_DETECTED,
            jproxy.encode_node_detected(jproxy.NodeDetectedPacket(**det)))
        assert tproxy.frame_packet(
            tproxy.PACKET_DETECTED,
            tproxy.encode_node_detected(tproxy.NodeDetectedPacket(**det))) \
            == wire
        assert tproxy.parse_packet(wire) == jproxy.parse_packet(wire)


def test_local_proxy_and_downlink_bytes_equal(rng):
    pj, pt = jproxy.LocalProxy(2), tproxy.LocalProxy(2)
    dj, dt = jproxy.FusedDownlink(2, 5.0), tproxy.FusedDownlink(2, 5.0)
    for k in range(12):
        pose, vel = rng.normal(size=4), rng.normal(size=3)
        dist = {j: float(rng.uniform(0, 9)) for j in range(4) if j != 2}
        pj.on_self_odometry(0.1 * k, pose, vel)
        pt.on_self_odometry(0.1 * k, pose, vel)
        assert pt.framed_uwb_tick(0.1 * k, dist) == \
            pj.framed_uwb_tick(0.1 * k, dist)
        rel = {d: rng.normal(size=4) for d in range(4)}
        assert dt.tick(0.1 * k, rel) == dj.tick(0.1 * k, rel)
    sj, st = jproxy.TimeSync(), tproxy.TimeSync()
    for k in range(5):
        sj.add_reference(10.0 + k, 100.0 + 1.001 * k)
        st.add_reference(10.0 + k, 100.0 + 1.001 * k)
    assert st.lps_to_host(17.5) == sj.lps_to_host(17.5)


def _published(mod, kf_dict, **net_kw):
    """Every message a LoopNet publishes for one keyframe, as recorded by a
    LossyBus subclass of the same package."""
    log = []

    class Recorder(mod.LossyBus):
        def publish(self, sender_id, channel, msg, t):
            log.append((channel, msg))
            super().publish(sender_id, channel, msg, t)

    bus = Recorder()
    net = mod.LoopNet(bus, 1, **net_kw)
    mod.LoopNet(bus, 2)
    net.broadcast_keyframe(mod.KeyframeData(**kf_dict), 0.0)
    return log, bus.bytes_sent


def test_loopnet_packets_equal():
    kf = ref_comm_tests.make_kf(drone=1, frame=4, K=30).__dict__
    kf["valid"] = kf["valid"].copy()
    kf["valid"][::7] = False
    for kw in ({}, {"send_whole_img_desc": True}):
        lj, bj = _published(jcomm, kf, **kw)
        lt, bt = _published(tcomm, kf, **kw)
        assert bt == bj and len(lt) == len(lj)
        for (cj, mj), (ct, mt) in zip(lj, lt):
            assert ct == cj and type(mt).__name__ == type(mj).__name__
            assert mt.nbytes() == mj.nbytes()
            if isinstance(mj, jcomm.LandmarkPacket):
                assert mt.desc_q.tobytes() == mj.desc_q.tobytes()
                assert (mt.index, mt.desc_scale) == (mj.index, mj.desc_scale)
                assert mt.xy.tobytes() == mj.xy.tobytes()
                assert mt.p3d.tobytes() == mj.p3d.tobytes()
            elif isinstance(mj, jcomm.HeaderPacket):
                assert mt.global_desc_q.tobytes() == \
                    mj.global_desc_q.tobytes()
                assert mt.num_landmarks == mj.num_landmarks
    edge = dict(drone_a=0, t_a=1.0, drone_b=2, t_b=3.0,
                dpose=np.ones(4, np.float32), pos_std=0.1, yaw_std=0.1)
    assert tcomm.LoopEdgePacket(**edge).nbytes() == \
        jcomm.LoopEdgePacket(**edge).nbytes()
    assert tcomm.InlierSetPacket(0, 1, [(1, 2, 3, 4)] * 3).nbytes() == \
        jcomm.InlierSetPacket(0, 1, [(1, 2, 3, 4)] * 3).nbytes()


def test_lossy_bus_stream_equal():
    """Drops and delivery order draw for draw, over a lossy, late bus with
    several subscribers."""
    logs = []
    for mod in (jcomm, tcomm):
        bus = mod.LossyBus(drop_rate=0.3, latency=0.05, seed=9)
        got = []
        for peer in range(4):
            bus.subscribe(peer, "CH", lambda m, p=peer: got.append((p, m)))
        for i in range(60):
            bus.publish(i % 4, "CH", i, t=0.01 * i)
            if i % 7 == 0:
                bus.step(0.01 * i)
        bus.step(10.0)
        logs.append((got, dict(bus.bytes_sent)))
    assert logs[0] == logs[1]


def test_loopnet_reassembly_equal():
    """A lossy bus: the partial keyframes each package reassembles, and the
    receive rates, are equal."""
    outs = []
    for mod in (jcomm, tcomm):
        bus = mod.LossyBus(drop_rate=0.25, seed=4)
        got = []
        nets = [mod.LoopNet(bus, d, on_keyframe=got.append)
                for d in range(3)]
        for f in range(4):
            for d in range(3):
                kf = ref_comm_tests.make_kf(drone=d, frame=f, seed=10 * f + d)
                nets[d].broadcast_keyframe(mod.KeyframeData(**kf.__dict__),
                                           float(f))
            bus.step(float(f))
            for net in nets:
                net.scan_recv_packets(float(f) + 0.5)
        for net in nets:
            net.scan_recv_packets(100.0)
        outs.append((got, [[net.receive_rate(d) for d in range(3)]
                           for net in nets]))
    (gj, rj), (gt, rt) = outs
    assert rt == rj and len(gt) == len(gj) > 0
    for a, b in zip(gt, gj):
        assert (a.drone_id, a.frame_id) == (b.drone_id, b.frame_id)
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_array_equal(a.local_desc, b.local_desc)
        np.testing.assert_array_equal(a.global_desc, b.global_desc)


def test_jpeg_bytes_equal(rng):
    img = rng.uniform(0, 1, size=(48, 64)).astype(np.float32)
    wire = jcomm.encode_image(img, quality=50)
    assert tcomm.encode_image(img, quality=50) == wire
    np.testing.assert_array_equal(tcomm.decode_image(wire),
                                  jcomm.decode_image(wire))


def test_loopnet_drops_a_keyframe_without_landmarks():
    """A header whose landmark datagrams were all lost gives no keyframe
    (the reference assembles one with a (K, 0) descriptor block, on which
    its detector fails); with one landmark left, both packages assemble
    the same keyframe."""
    kf = ref_comm_tests.make_kf(drone=1, frame=3, seed=5)
    outs = {}
    for name, mod in (("jax", jcomm), ("port", tcomm)):
        for keep in (0, 1):
            bus = mod.LossyBus()
            got = []
            rx = mod.LoopNet(bus, 0, on_keyframe=got.append)
            tx = mod.LoopNet(bus, 1)
            tx.broadcast_keyframe(mod.KeyframeData(**kf.__dict__), 0.0)
            lms = [m for m in bus._queue
                   if m[3] == mod.CHANNEL_VIOKF_LANDMARKS]
            bus._queue = [m for m in bus._queue if m not in lms[keep:]]
            heapq.heapify(bus._queue)
            bus.step(1.0)
            rx.scan_recv_packets(1.0)        # first seen
            rx.scan_recv_packets(100.0)      # expired
            outs[name, keep] = got
    assert outs["port", 0] == []
    assert len(outs["jax", 0]) == 1
    assert outs["jax", 0][0].local_desc.shape[1] == 0
    (a,), (b,) = outs["jax", 1], outs["port", 1]
    np.testing.assert_array_equal(a.local_desc, b.local_desc)
    np.testing.assert_array_equal(a.valid, b.valid)
