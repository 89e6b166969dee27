"""The port's checkpoint, recorder, configuration and telemetry against the
JAX package's: the same on-disk formats, fields and defaults."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch import config as tconfig
from omniswarm_torch.io import checkpoint as tckpt
from omniswarm_torch.io import recorder as trec
from omniswarm_torch.swarm import estimator as test_mod
from omniswarm_torch.utils import telemetry as ttel
from omniswarm_tpu import config as jconfig
from omniswarm_tpu import sim
from omniswarm_tpu.io import checkpoint as jckpt
from omniswarm_tpu.io import recorder as jrec
from omniswarm_tpu.swarm import estimator as ref_mod
from omniswarm_tpu.utils import telemetry as jtel

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_estimator_build import feed, scenario  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def fed(mod, params_mod, **est_kw):
    """An estimator of ``mod`` fed a 3-drone stream (with a stand-in
    estimate, as a solve would leave it)."""
    est = mod.SwarmEstimator(params_mod.SolverParams(
        kf_movement=0.2, loop_outlier_distance_threshold=50.0), **est_kw)
    for ev in scenario(drones=3, frames=16, seed=2, prepare_at=()):
        feed(est, mod, ev)
    ids = est._drone_ids()
    est.estimate = est._vio_grid({d: i for i, d in enumerate(ids)}) + 0.01
    est.window_ids = ids
    est.finish_init = True
    est.last_cost = 12.5
    est.solve_count = 3
    return est


def assert_state_equal(a, b):
    for name in ("self_id", "finish_init", "last_cost", "solve_count",
                 "window_ids"):
        assert getattr(a, name) == getattr(b, name), name
    assert [kf.t for kf in a.window] == [kf.t for kf in b.window]
    for ka, kb in zip(a.window, b.window):
        assert sorted(ka.vio) == sorted(kb.vio) and ka.ranges == kb.ranges
        for d in ka.vio:
            np.testing.assert_array_equal(ka.vio[d], kb.vio[d])
    for la, lb in zip(a.loops, b.loops):
        assert (la.t_a, la.drone_a, la.t_b, la.drone_b, la.pos_std,
                la.yaw_std) == (lb.t_a, lb.drone_a, lb.t_b, lb.drone_b,
                                lb.pos_std, lb.yaw_std)
        np.testing.assert_array_equal(la.dpose, lb.dpose)
    assert len(a.loops) == len(b.loops) and len(a.dets) == len(b.dets)
    for da, db in zip(a.dets, b.dets):
        assert (da.t, da.drone_a, da.drone_b, da.inv_dep, da.enable_depth) \
            == (db.t, db.drone_a, db.drone_b, db.inv_dep, db.enable_depth)
        np.testing.assert_array_equal(da.direction, db.direction)
    assert sorted(a.ego) == sorted(b.ego)
    for d in a.ego:
        np.testing.assert_array_equal([p for _, p in a.ego[d]],
                                      [p for _, p in b.ego[d]])
    np.testing.assert_array_equal(a.estimate, b.estimate)
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    path = str(tmp_path / "est.npz")
    if direction == "jax_to_port":
        src = fed(ref_mod, jconfig)
        jckpt.save_estimator(src, path)
        got = tckpt.load_estimator(path, device="cpu")
        assert isinstance(got, test_mod.SwarmEstimator)
    else:
        src = fed(test_mod, tconfig, device="cpu")
        tckpt.save_estimator(src, path)
        got = jckpt.load_estimator(path)
        assert isinstance(got, ref_mod.SwarmEstimator)
    assert_state_equal(got, src)
    t = src.window[-1].t + 0.5
    for d in src.window_ids:
        newer = src.ego[d][-1][1] + 0.1
        src.on_vio(t, d, newer)
        got.on_vio(t, d, newer)
    want_pred = src.predict_swarm_relative(t)
    got_pred = got.predict_swarm_relative(t)
    assert sorted(got_pred) == sorted(want_pred) and len(want_pred) == 3
    for d in want_pred:
        np.testing.assert_array_equal(got_pred[d], want_pred[d])
    np.testing.assert_array_equal(
        np.asarray([got.base_coordinates()[d] for d in src.window_ids]),
        np.asarray([src.base_coordinates()[d] for d in src.window_ids]))


def test_recording_roundtrip_and_replay(tmp_path):
    data = sim.generate(sim.SimParams(num_drones=3, num_frames=12, seed=4))
    rec = trec.Recording()
    for k in range(12):
        rec.record_frame(data.times[k], {d: data.vio[k, d] for d in range(3)},
                         {(0, 1): float(data.ranges[k, 0, 1]),
                          (1, 2): float(data.ranges[k, 1, 2])})
    for lp in data.loops:
        rec.loops.append(test_mod.LoopRecord(
            t_a=float(data.times[lp.frame_a]), drone_a=lp.drone_a,
            t_b=float(data.times[lp.frame_b]), drone_b=lp.drone_b,
            dpose=lp.dpose, pos_std=lp.pos_std, yaw_std=lp.yaw_std))
    for det in data.detections[:10]:
        rec.dets.append(test_mod.DetRecord(
            t=float(data.times[det.frame]), drone_a=det.drone_a,
            drone_b=det.drone_b, direction=det.direction,
            inv_dep=det.inv_dep, enable_depth=False))
    path = str(tmp_path / "rec.npz")
    rec.save(path)
    back = jrec.Recording.load(path)           # the reference reads it
    again = trec.Recording.load(path)
    assert len(back.frames) == len(again.frames) == 12
    assert len(again.loops) == len(rec.loops) and len(again.dets) == 10
    for (t0, v0, r0), (t1, v1, r1) in zip(back.frames, again.frames):
        assert t0 == t1 and r0 == r1
        for d in v0:
            np.testing.assert_array_equal(v0[d], v1[d])
    ref = ref_mod.SwarmEstimator(jconfig.SolverParams())
    port = test_mod.SwarmEstimator(tconfig.SolverParams(), device="cpu")
    back.replay_into(ref)
    again.replay_into(port)
    assert [kf.t for kf in port.window] == [kf.t for kf in ref.window]
    assert len(port.loops) == len(ref.loops) > 0
    assert len(port.dets) == len(ref.dets) == 10


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["SolverParams", "FrontendParams",
                                  "NodeConfig", "SwarmConfig"])
def test_config_fields_and_defaults(name):
    got, want = getattr(tconfig, name), getattr(jconfig, name)
    assert [n for n, _ in _fields(got)] == [n for n, _ in _fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


def test_swarm_config_from_yaml(tmp_path):
    path = str(ROOT / "configs" / "swarm5.yaml")
    got, want = tconfig.SwarmConfig.from_yaml(path), \
        jconfig.SwarmConfig.from_yaml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.solver.max_iterations == 60 and got.nodes[4].is_static
    out = str(tmp_path / "back.yaml")
    got.to_yaml(out)
    assert dataclasses.asdict(jconfig.SwarmConfig.from_yaml(out)) == \
        dataclasses.asdict(want)


def test_telemetry_report(tmp_path):
    reports = []
    for mod in (jtel, ttel):
        tel = mod.Telemetry()
        with tel.scope("a"):
            pass
        with tel.scope("a", block_on=torch.zeros(2) if mod is ttel
                       else None):
            pass
        tel.record_ms("b", 4.0)
        tel.record_ms("b", 2.0)
        tel.count("bytes", 10)
        tel.count("bytes", 5)
        rep = tel.report()
        rep["timers"]["a"] = {"count": rep["timers"]["a"]["count"]}
        reports.append(rep)
        tel.dump_json(str(tmp_path / "t.json"))
        assert "b" in tel.summary() and tel.timer("b").avg_ms == 3.0
    assert reports[0] == reports[1]
    assert reports[1]["counters"] == {"bytes": 15.0}
    assert isinstance(ttel.GLOBAL, ttel.Telemetry)
