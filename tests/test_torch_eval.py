"""The port's eval, utils and diagnostics modules against the JAX package's.

Each function runs on the same inputs in both packages: the calibration
fits of ``tests/test_calibration.py`` (results equal to 1e-9 relative,
then the reference's own bars), ``evaluate`` / ``write_report`` and
``write_pcm_debug`` (the JSON written, equal), ``save_match_image`` (a PNG
in both), ``graph_to_dot`` (the text, equal, for both graph types) and the
crash diagnostics of ``tests/test_diagnostics.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from omniswarm_torch import sim as tsim
from omniswarm_torch.config import SwarmConfig as TSwarmConfig
from omniswarm_torch.eval import calibration as tcal
from omniswarm_torch.eval import match_viz as tviz
from omniswarm_torch.eval import pcm_debug as tpcm_debug
from omniswarm_torch.eval import report as treport
from omniswarm_torch.utils import cgraph as tcgraph
from omniswarm_torch.utils.diagnostics import (install_crash_handler,
                                               install_hang_watchdog)
from omniswarm_tpu import sim
from omniswarm_tpu.config import SwarmConfig
from omniswarm_tpu.eval import calibration as jcal
from omniswarm_tpu.eval import match_viz as jviz
from omniswarm_tpu.eval import pcm_debug as jpcm_debug
from omniswarm_tpu.eval import report as jreport
from omniswarm_tpu.utils import cgraph as jcgraph

torch.set_num_threads(1)


def same_calibration(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-12), k


# ---------------------------------------------------------------------------
# calibration: tests/test_calibration.py's five cases
# ---------------------------------------------------------------------------

def test_fit_uwb_calibration_recovers_bias_scale():
    rng = np.random.default_rng(0)
    true = rng.uniform(1.0, 8.0, size=400)
    bias, scale, noise = 0.35, 1.08, 0.05
    raw = bias + scale * true + rng.normal(0, noise, size=true.shape)
    cal = tcal.fit_uwb_calibration(raw, true)
    same_calibration(cal, jcal.fit_uwb_calibration(raw, true))
    assert abs(cal.bias - bias) < 0.05
    assert abs(cal.scale - scale) < 0.02
    assert abs(cal.std_calibrated - noise / scale) < 0.02
    assert cal.rmse_raw > 0.3
    assert cal.num_samples == 400


def test_uwb_pair_calibrations_from_sim():
    params = sim.SimParams(num_drones=3, num_frames=120, seed=5,
                           uwb_noise_std=0.03, uwb_bias=0.4, uwb_scale=1.1)
    data = sim.generate(params)
    calibs = tcal.uwb_pair_calibrations(data.ranges, data.range_valid,
                                        data.gt[..., :3])
    want = jcal.uwb_pair_calibrations(data.ranges, data.range_valid,
                                      data.gt[..., :3])
    assert sorted(calibs) == sorted(want) and len(calibs) == 6
    for pair, cal in calibs.items():
        same_calibration(cal, want[pair])
        assert abs(cal.bias - 0.4) < 0.12
        assert abs(cal.scale - 1.1) < 0.04
        assert cal.std_calibrated < 0.06

    cfg, jcfg = TSwarmConfig(), SwarmConfig()
    tcal.apply_uwb_calibrations(cfg, calibs)
    jcal.apply_uwb_calibrations(jcfg, want)
    assert {d: dataclasses.asdict(n) for d, n in cfg.nodes.items()} == \
        {d: dataclasses.asdict(n) for d, n in jcfg.nodes.items()}
    from omniswarm_torch.swarm import SwarmEstimator

    est = SwarmEstimator(cfg.solver, node_configs=cfg.nodes, device="cpu")
    measured = calibs[(0, 1)].bias + calibs[(0, 1)].scale * 4.0
    assert abs(est._calibrate_range((0, 1), measured) - 4.0) < 1e-9


def test_odometry_covariance_per_meter_recovers_drift():
    rng = np.random.default_rng(1)
    F, step_len, step_std = 4000, 0.5, 0.02
    yaw = np.zeros(F)
    pos_gt = np.zeros((F, 3))
    pos_gt[:, 0] = np.arange(F) * step_len
    noise = rng.normal(0, step_std, size=(F, 3))
    noise[0] = 0
    pos_vo = pos_gt + np.cumsum(noise, axis=0)
    args = (pos_vo, yaw, pos_gt, yaw)
    pos_cov, yaw_var = tcal.odometry_covariance_per_meter(
        *args, rp_lengths=(1.0,), step=2)
    want_cov, want_yaw = jcal.odometry_covariance_per_meter(
        *args, rp_lengths=(1.0,), step=2)
    np.testing.assert_allclose(pos_cov, want_cov, rtol=1e-9)
    assert yaw_var == want_yaw == 0.0
    expected = step_std ** 2 / step_len
    diag = np.diag(pos_cov)
    assert np.all(diag > 0.3 * expected)
    assert np.all(diag < 3.0 * expected)


def test_odometry_covariance_scales_with_noise():
    rng = np.random.default_rng(2)
    F = 2000
    yaw = rng.normal(0, 0.1, size=F)
    pos_gt = np.cumsum(rng.normal(0, 0.3, size=(F, 3)), axis=0)

    def vo_with(std, seed):
        r = np.random.default_rng(seed)
        n = r.normal(0, std, size=(F, 3))
        n[0] = 0
        return pos_gt + np.cumsum(n, axis=0)

    covs = []
    for std, seed in ((0.01, 3), (0.04, 4)):
        vo = vo_with(std, seed)
        cov, var = tcal.odometry_covariance_per_meter(
            vo, yaw, pos_gt, yaw, rp_lengths=(1.0, 2.0), step=3)
        want, want_var = jcal.odometry_covariance_per_meter(
            vo, yaw, pos_gt, yaw, rp_lengths=(1.0, 2.0), step=3)
        np.testing.assert_allclose(cov, want, rtol=1e-9)
        assert var == pytest.approx(want_var, rel=1e-9)
        covs.append(cov)
    assert np.trace(covs[1]) > 5.0 * np.trace(covs[0])


def test_loop_error_stats_flags_outliers():
    params = dict(num_drones=3, num_frames=60, seed=9)
    data = sim.generate(sim.SimParams(**params, loop_outlier_rate=0.2,
                                      loop_outlier_mag=6.0))
    stats = tcal.loop_error_stats(data.loops, data.gt)
    assert stats == pytest.approx(jcal.loop_error_stats(data.loops, data.gt),
                                  rel=1e-12)
    assert stats["num_loops"] == len(data.loops)
    assert stats["gross_outlier_frac"] > 0.05
    clean = tsim.generate(tsim.SimParams(**params))
    assert tcal.loop_error_stats(clean.loops, clean.gt)["pos_rmse"] \
        < stats["pos_rmse"]


def test_fit_uwb_anchor_matches_reference():
    rng = np.random.default_rng(4)
    pos = np.array([0.5, -0.2, 1.2]) + rng.normal(0, 0.05, size=(200, 3))
    anchor, bias = np.array([2.0, 1.0, 0.3]), 0.25
    raw = (np.linalg.norm(pos - anchor, axis=1) + bias
           + rng.normal(0, 0.02, size=200))
    got = tcal.fit_uwb_anchor(pos, raw)
    assert got == pytest.approx(jcal.fit_uwb_anchor(pos, raw), rel=1e-9)
    assert got["residual_std"] < 0.05


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def assert_json_close(a, b, rel):
    """Equal JSON trees, floats within ``rel``."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_json_close(a[k], b[k], rel)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_json_close(x, y, rel)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=rel)
    else:
        assert a == b


def read_json(path):
    with open(path) as f:
        return json.load(f)


def test_evaluate_and_write_report_match(tmp_path):
    data = sim.generate(sim.SimParams(num_drones=3, num_frames=20, seed=61))
    est = data.vio + 0.01
    got = treport.evaluate(est, data.gt, data.ranges, data.range_valid)
    want = jreport.evaluate(est, data.gt, data.ranges, data.range_valid)
    assert json.dumps(got, default=float) == json.dumps(want, default=float)
    assert treport.evaluate(data.gt, data.gt)["mean_relative_ate"] == 0.0
    kw = dict(times=data.times, ranges=data.ranges,
              range_valid=data.range_valid, vio=data.vio)
    treport.write_report(str(tmp_path / "port"), est, data.gt, **kw)
    jreport.write_report(str(tmp_path / "ref"), est, data.gt, **kw)
    assert read_json(tmp_path / "port" / "summary.json") == \
        read_json(tmp_path / "ref" / "summary.json")
    for name in ("fused_err.png", "relative_err.png"):
        assert (tmp_path / "port" / name).stat().st_size > 1000


def test_write_pcm_debug_matches(tmp_path):
    from omniswarm_torch.robust import pcm as tpcm
    from omniswarm_tpu.robust import pcm as jpcm

    data = sim.generate(sim.SimParams(num_drones=3, num_frames=40, seed=3,
                                      loop_outlier_rate=0.3,
                                      loop_outlier_mag=4.0))
    tloops = tpcm.loopset_from_measurements(data.loops)
    jloops = jpcm.loopset_from_measurements(data.loops)
    got = tpcm.pcm_filter(tloops, data.vio, device="cpu", return_smd=True)
    want = jpcm.pcm_filter(jloops, data.vio, return_smd=True)
    np.testing.assert_array_equal(got.good_mask, want.good_mask)
    a = tpcm_debug.write_pcm_debug(str(tmp_path / "port"), tloops, got,
                                   gt=data.gt)
    b = jpcm_debug.write_pcm_debug(str(tmp_path / "ref"), jloops, want,
                                   gt=data.gt)
    assert a["n_loops"] == len(data.loops) > 2
    ja = read_json(tmp_path / "port" / "pcm_debug.json")
    jb = read_json(tmp_path / "ref" / "pcm_debug.json")
    smd_a = [r.pop("min_smd") for r in ja["loops"]]
    smd_b = [r.pop("min_smd") for r in jb["loops"]]
    # the consistency errors are f32 sums in two orders
    np.testing.assert_allclose(smd_a, smd_b, rtol=1e-4, atol=1e-5)
    # the true errors: the port's loop set keeps f64 dposes, the
    # reference's f32
    assert_json_close(ja, jb, rel=1e-6)
    assert sorted(p.name for p in (tmp_path / "port").glob("*.png")) == \
        sorted(p.name for p in (tmp_path / "ref").glob("*.png"))
    assert a["n_accepted"] == b["n_accepted"]


def test_save_match_image_in_both(tmp_path):
    rng = np.random.default_rng(8)
    img_a = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    img_b = (255 * rng.uniform(0, 1, (50, 70))).astype(np.uint8)
    kp_a = rng.uniform(0, 60, (30, 2))
    kp_b = rng.uniform(0, 50, (40, 2))
    idx_b = rng.integers(0, 40, 30)
    mask = rng.uniform(size=30) < 0.7
    inliers = mask & (rng.uniform(size=30) < 0.6)
    for mod, name in ((tviz, "port"), (jviz, "ref")):
        path = mod.save_match_image(img_a, kp_a, img_b, kp_b, idx_b, mask,
                                    inliers, str(tmp_path / name / "m.png"))
        assert path.endswith("m.png")
        assert (tmp_path / name / "m.png").stat().st_size > 1000


# ---------------------------------------------------------------------------
# graph_to_dot: both graph types
# ---------------------------------------------------------------------------

def test_graph_to_dot_matches_both_graph_types(tmp_path):
    from omniswarm_torch.convert import (dense_graph_to_torch,
                                         factor_graph_to_torch)
    from omniswarm_tpu.sim.pipeline import build_graph_from_sim
    from omniswarm_tpu.solver.dense import dense_graph_from_sim

    data = sim.generate(sim.SimParams(num_drones=3, num_frames=8, seed=2))
    fg, _ = build_graph_from_sim(data)
    dg = dense_graph_from_sim(data)
    for jg, tg in ((fg, factor_graph_to_torch(fg, "cpu")),
                   (dg, dense_graph_to_torch(dg, "cpu"))):
        want = jcgraph.graph_to_dot(jg)
        got = tcgraph.graph_to_dot(tg, str(tmp_path / "g.dot"))
        assert got == want and "--" in got
        assert (tmp_path / "g.dot").read_text() == want


# ---------------------------------------------------------------------------
# diagnostics: tests/test_diagnostics.py's cases
# ---------------------------------------------------------------------------

def test_crash_handler_installs():
    import faulthandler

    install_crash_handler()
    assert faulthandler.is_enabled()


def test_watchdog_cancel():
    w = install_hang_watchdog(30.0)
    w.cancel()
    assert not w.is_alive() or w.finished.is_set()


def test_watchdog_fires(capfd):
    import time

    w = install_hang_watchdog(0.05)
    w.join(5.0)
    time.sleep(0.05)
    assert "watchdog fired" in capfd.readouterr().err


def test_telemetry_scopes_and_counters(tmp_path):
    import time

    from omniswarm_torch.utils.telemetry import Telemetry

    tm = Telemetry()
    with tm.scope("solve"):
        time.sleep(0.01)
    with tm.scope("solve"):
        time.sleep(0.005)
    tm.count("bytes_sent", 1024)
    tm.count("bytes_sent", 512)
    rep = tm.report()
    assert rep["timers"]["solve"]["count"] == 2
    assert rep["timers"]["solve"]["avg_ms"] >= 5
    assert rep["counters"]["bytes_sent"] == 1536
    path = tmp_path / "telemetry.json"
    tm.dump_json(str(path))
    assert read_json(path)["timers"]["solve"]["count"] == 2
    assert "solve" in tm.summary()
