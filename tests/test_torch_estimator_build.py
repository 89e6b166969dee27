"""The port's estimator host phase against the JAX package's, step by step.

The same measurement stream goes into a reference ``SwarmEstimator`` and the
port's (on the CPU); after each step both run ``prepare_solve`` (numpy plus
one PCM mask: no solve) and must agree exactly: the window's keyframe times,
every leaf of the graph ``build_dense_fast`` (or the slow ``_build`` →
``dense_from_factor_graph`` fallback) assembles, the init and the
multi-init lanes (the same numpy draws) and the PCM inlier sets.
"""
import numpy as np
import pytest
import torch

from omniswarm_torch import config as tconfig
from omniswarm_torch.robust.da_init import ANONYMOUS_ID_BASE as T_ANON
from omniswarm_torch.swarm import estimator as test_mod
from omniswarm_tpu import config as jconfig
from omniswarm_tpu.robust.da_init import ANONYMOUS_ID_BASE
from omniswarm_tpu.swarm import estimator as ref_mod

torch.set_num_threads(1)


def quat_rp(roll, pitch, yaw):
    from omniswarm_tpu.core.geometry import quat_from_rpy_np

    return quat_from_rpy_np(roll, pitch, yaw)


def scenario(*, drones=4, frames=24, seed=0, loops=30, dets=12,
             outliers=0.2, gap_drone=None, six_dof=False, anonymous=False,
             prepare_at=(10, 17, None)):
    """A list of events: ("frame", t, vio, ranges, vio6), ("loop", kwargs),
    ("det", kwargs), ("prepare",). Loops and detections are measured from
    the VIO truth (a fraction of the loops are outliers) and arrive once
    both endpoints exist; ``prepare_at`` lists the frames after which the
    estimators prepare a solve (None: after the last)."""
    rng = np.random.default_rng(seed)
    t0 = 100.0
    truth = {d: np.array([d * 0.6, -0.4 * d, 0.1 * d, 0.1 * d])
             for d in range(drones)}
    hist = {d: {} for d in range(drones)}
    att = {d: {} for d in range(drones)}
    frame_events = []
    for i in range(frames):
        t = t0 + i
        vio, vio6 = {}, {}
        for d in range(drones):
            if d == gap_drone and i in (7, 8):
                continue
            truth[d] = truth[d] + np.array(
                [0.8 + 0.1 * rng.normal(), 0.1 * rng.normal(),
                 0.05 * rng.normal(), 0.02 * rng.normal()])
            vio[d] = truth[d] + rng.normal(0, 0.01, 4)
            hist[d][i] = vio[d]
            rp = rng.normal(0, 0.15, 2) if six_dof else (0.0, 0.0)
            att[d][i] = rp
            vio6[d] = np.concatenate(
                [vio[d][:3], quat_rp(rp[0], rp[1], vio[d][3])])
        ranges = {}
        for a in range(drones):
            for b in range(drones):
                if a < b and a in vio and b in vio and rng.random() < 0.8:
                    ranges[(a, b)] = float(np.linalg.norm(
                        vio[a][:3] - vio[b][:3])) + rng.normal(0, 0.05)
        frame_events.append([("frame", t, vio, ranges,
                              vio6 if six_dof else None)])
    from omniswarm_tpu.core.geometry import se3_delta_np, se3_to_pose4_np
    from omniswarm_tpu.sim.simulator import delta_pose_np

    for k in range(loops):
        a, b = (int(x) for x in rng.choice(drones, 2, replace=False))
        fa, fb = (int(x) for x in rng.integers(2, frames - 1, 2))
        if fa not in hist[a] or fb not in hist[b]:
            continue
        dp = delta_pose_np(hist[a][fa], hist[b][fb]) + rng.normal(0, 0.01, 4)
        if rng.random() < outliers:
            dp = dp + rng.normal(0, 1.0, 4)
        kw = dict(t_a=t0 + fa, drone_a=a, t_b=t0 + fb, drone_b=b, dpose=dp,
                  pos_std=0.05, yaw_std=0.02)
        if six_dof:
            p6a = np.concatenate([hist[a][fa][:3],
                                  quat_rp(*att[a][fa], hist[a][fa][3])])
            p6b = np.concatenate([hist[b][fb][:3],
                                  quat_rp(*att[b][fb], hist[b][fb][3])])
            kw["dpose6"] = se3_delta_np(p6a, p6b)
            kw["dpose"] = se3_to_pose4_np(kw["dpose6"])
        frame_events[max(fa, fb)].append(("loop", kw))
        if k % 3 == 0:
            # same keyframe pair, another measurement (0.3 s later)
            dup = dict(kw, t_a=kw["t_a"] + 0.3, pos_std=0.08, yaw_std=0.03,
                       dpose=kw["dpose"] + rng.normal(0, 0.005, 4))
            frame_events[max(fa, fb)].append(("loop", dup))
    for k in range(dets):
        a, b = (int(x) for x in rng.choice(drones, 2, replace=False))
        f = int(rng.integers(2, frames - 1))
        if f not in hist[a] or f not in hist[b]:
            continue
        diff = hist[b][f][:3] - hist[a][f][:3]
        dist = np.linalg.norm(diff) + 1e-6
        target = ANONYMOUS_ID_BASE + 10 * b + 1 if anonymous and k % 2 \
            else b
        frame_events[f].append(("det", dict(
            t=t0 + f, drone_a=a, drone_b=target, direction=diff / dist,
            inv_dep=1.0 / dist, enable_depth=bool(k % 2))))
    events = []
    for i, evs in enumerate(frame_events):
        events += evs
        if i + 1 in prepare_at:
            events.append(("prepare",))
    if None in prepare_at:
        events.append(("prepare",))
    return events


def feed(est, mod, event):
    kind = event[0]
    if kind == "frame":
        _, t, vio, ranges, vio6 = event
        est.on_swarm_frame(t, vio, ranges, vio6=vio6)
    elif kind == "loop":
        est.on_loop(mod.LoopRecord(**event[1]))
    elif kind == "det":
        est.on_detection(mod.DetRecord(**event[1]))


def leaves(graph):
    """(name, array) of every leaf of a DenseGraph or FactorGraph."""
    out = []
    for name, v in graph._asdict().items():
        if v is None:
            out.append((name, None))
        elif hasattr(v, "_fields"):
            out += [(f"{name}.{k}", np.asarray(x))
                    for k, x in v._asdict().items()]
        else:
            out.append((name, np.asarray(v)))
    return out


def assert_leaves_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)


def assert_prep_equal(got, want):
    assert got["refused"] == want["refused"]
    if want["refused"]:
        assert got["status"] == want["status"]
        return
    for key in ("F", "D", "idmap", "num_window", "multi_init", "solve_kw"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["init"], want["init"])
    if want["inits"] is None:
        assert got["inits"] is None
    else:
        np.testing.assert_array_equal(got["inits"], want["inits"])
    assert (got["graph"] is None) == (want["graph"] is None)
    if want["graph"] is not None:
        assert_leaves_equal(got["graph"], want["graph"])
    assert (got["dense_graph"] is None) == (want["dense_graph"] is None)
    if want["dense_graph"] is not None:
        assert_leaves_equal(got["dense_graph"], want["dense_graph"])


def run_both(events, params_kw, *, node_configs=None, rng_seed=0,
             between=None):
    """Feed both estimators; compare at each prepare. ``between(ref, port,
    step)`` runs after each comparison (e.g. to install an estimate)."""
    ref = ref_mod.SwarmEstimator(
        jconfig.SolverParams(**params_kw), rng_seed=rng_seed,
        node_configs=None if node_configs is None
        else node_configs(jconfig.NodeConfig))
    port = test_mod.SwarmEstimator(
        tconfig.SolverParams(**params_kw), rng_seed=rng_seed, device="cpu",
        node_configs=None if node_configs is None
        else node_configs(tconfig.NodeConfig))
    steps = 0
    for ev in events:
        if ev[0] != "prepare":
            feed(ref, ref_mod, ev)
            feed(port, test_mod, ev)
            continue
        want, got = ref.prepare_solve(), port.prepare_solve()
        assert [kf.t for kf in port.window] == [kf.t for kf in ref.window]
        assert_prep_equal(got, want)
        assert port.pair_inliers == ref.pair_inliers
        assert port.window_ids == ref.window_ids
        steps += 1
        if between is not None:
            between(ref, port, steps)
    # the async PCM launched at the last prepare, folded in
    from omniswarm_torch.swarm.fastbuild import consume_pcm_pending as tc
    from omniswarm_tpu.swarm.fastbuild import consume_pcm_pending as jc

    jc(ref)
    tc(port)
    assert port.pair_inliers == ref.pair_inliers
    return ref, port, steps


def install_estimate(seed):
    """After each prepare, give both estimators the same warm estimate
    (VIO grid plus noise) so the next build gates ranges on it and warm
    starts from it."""
    def between(ref, port, step):
        rng = np.random.default_rng(seed + step)
        ids = ref._drone_ids()
        grid = ref._vio_grid({d: i for i, d in enumerate(ids)})
        est = grid + rng.normal(0, 0.02, grid.shape).astype(np.float32)
        for e in (ref, port):
            e.estimate = est.copy()
            e.window_ids = list(ids)
            e.finish_init = True
    return between


def test_default_session():
    """SolverParams defaults (non-redundant PCM, self 0, a 100-frame
    window), outliers among the loops; the loop intake gate is widened so
    the scenario's long loops pass it."""
    events = scenario(seed=0)
    ref, port, steps = run_both(events, dict(
        kf_movement=0.2, loop_outlier_distance_threshold=50.0))
    assert steps == 3 and len(ref.window) == 24
    assert ref.pair_inliers


@pytest.mark.parametrize("redundant", [True, False])
def test_warm_estimate_and_range_gating(redundant):
    events = scenario(seed=1, prepare_at=(8, 12, 16, 20, None))
    run_both(events, dict(kf_movement=0.2, pcm_redundant=redundant,
                          loop_outlier_distance_threshold=50.0),
             between=install_estimate(1))


def test_node_configs():
    """A static anchor, a drone without VO, UWB bias and scale, and an
    antenna offset (tests/test_fastbuild.py, test_node_configs.py,
    test_knobs.py)."""
    def configs(cls):
        return {0: cls(drone_id=0, antenna_pos=(0.1, 0.0, 0.05),
                       uwb_bias={1: 0.3}, uwb_scale={1: 1.02}),
                2: cls(drone_id=2, is_static=True),
                3: cls(drone_id=3, has_vo=False)}

    events = scenario(seed=3)
    ref, port, _ = run_both(events, dict(
        kf_movement=0.2, loop_outlier_distance_threshold=50.0),
        node_configs=configs)
    assert ref.window[0].ranges == port.window[0].ranges


def test_six_dof_loops():
    """6-DoF VIO histories and loops (test_loop6dof.py's dpose6): the
    re-anchoring composes full attitude before the 4-DoF flatten."""
    events = scenario(seed=4, six_dof=True, outliers=0.0)
    ref, port, _ = run_both(events, dict(
        kf_movement=0.2, loop_outlier_distance_threshold=50.0,
        pcm_redundant=True))
    assert any(lp.dpose6 is not None for lp in port.loops)


def test_anonymous_detections_with_da():
    """Anonymous detection targets resolved by the DA-init DFS
    (test_estimator_da.py), in place, the same way in both."""
    assert T_ANON == ANONYMOUS_ID_BASE
    events = scenario(seed=5, dets=14, anonymous=True)
    ref, port, _ = run_both(events, dict(
        kf_movement=0.2, enable_data_association=True, pcm_redundant=True))
    assert [d.drone_b for d in port.dets] == [d.drone_b for d in ref.dets]


def test_random_eviction():
    """max_frame_number=15: random mid-window deletion from the shared
    numpy stream keeps the windows identical, keyframe for keyframe."""
    events = scenario(drones=3, frames=40, seed=6,
                      prepare_at=(12, 20, 28, 34, None))
    ref, port, _ = run_both(events, dict(
        kf_movement=0.2, max_frame_number=15, dense_frame_number=5),
        rng_seed=7)
    assert len(port.window) == 15


def test_non_redundant_pcm_external_inliers():
    """Peer-broadcast inlier sets adopted for pairs without the self
    drone (outlier_rejection.cpp:122-158)."""
    events = scenario(seed=8, loops=40)

    def adopt(ref, port, step):
        full = {}
        for (a, b), keys in list(ref.pair_inliers.items()):
            full[(a, b)] = set(list(sorted(keys))[::2])
        for pair in ((1, 2), (1, 3), (2, 3)):
            full.setdefault(pair, set())
        ref.external_inliers = {k: set(v) for k, v in full.items()}
        port.external_inliers = {k: set(v) for k, v in full.items()}

    run_both(events, dict(kf_movement=0.2, pcm_redundant=False,
                          loop_outlier_distance_threshold=50.0),
             between=adopt)


@pytest.mark.parametrize("gap", [None, 2])
def test_slow_build_fallback(gap):
    """fast_build=False, and a chain gap that the fast build refuses: both
    take ``_build`` → ``dense_from_factor_graph``."""
    events = scenario(seed=9, gap_drone=gap)
    ref, port, _ = run_both(events, dict(
        kf_movement=0.2, fast_build=gap is not None,
        loop_outlier_distance_threshold=50.0))
    from omniswarm_torch.swarm.fastbuild import build_dense_fast

    assert (build_dense_fast(port) is None) == (gap is not None)
