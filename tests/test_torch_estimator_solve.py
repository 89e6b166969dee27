"""Whole estimator solves of the port against the JAX package's.

One session of 4 drones x 30 frames (``tests/test_estimator.py``'s seed 21)
goes into both packages' estimators, solved after frames 20, 25 and 30 with
``max_solver_time=0`` (iteration counts independent of the host's speed):
the first solve is the multi-init batch, the next two are warm. A second
session with ``acpt_cost=1`` rejects every solve, so its second solve is a
forced re-init (new jitter lanes from the shared numpy stream). Each
package's sessions run once (module fixtures); the tests read them.
"""
import numpy as np
import pytest
import torch

from omniswarm_torch import config as tconfig
from omniswarm_torch.swarm import estimator as test_mod
from omniswarm_tpu import config as jconfig
from omniswarm_tpu import sim
from omniswarm_tpu.swarm import estimator as ref_mod

torch.set_num_threads(1)
SOLVE_AT = (20, 25, 30)
REINIT_AT = (20, 25)
MAX_ITERATIONS = 40


def feed_until(est, mod, data, start, stop):
    """Frames [start, stop), each loop once both frames arrived, each
    detection at its frame."""
    D = data.gt.shape[1]
    for k in range(start, stop):
        ranges = {(a, b): float(data.ranges[k, a, b])
                  for a in range(D) for b in range(D)
                  if a != b and data.range_valid[k, a, b]}
        est.on_swarm_frame(float(data.times[k]),
                           {d: data.vio[k, d] for d in range(D)}, ranges)
        for lp in data.loops:
            if max(lp.frame_a, lp.frame_b) == k:
                est.on_loop(mod.LoopRecord(
                    t_a=float(data.times[lp.frame_a]), drone_a=lp.drone_a,
                    t_b=float(data.times[lp.frame_b]), drone_b=lp.drone_b,
                    dpose=lp.dpose, pos_std=lp.pos_std, yaw_std=lp.yaw_std))
        for det in data.detections:
            if det.frame == k:
                est.on_detection(mod.DetRecord(
                    t=float(data.times[k]), drone_a=det.drone_a,
                    drone_b=det.drone_b, direction=det.direction,
                    inv_dep=det.inv_dep))


def run_session(mod, cfg, data, solve_at, **params):
    kw = {} if mod is ref_mod else dict(device="cpu")
    est = mod.SwarmEstimator(cfg.SolverParams(
        self_id=0, pcm_redundant=True, max_solver_time=0.0,
        max_iterations=MAX_ITERATIONS, **params), rng_seed=0, **kw)
    outs, start = [], 0
    for stop in solve_at:
        feed_until(est, mod, data, start, stop)
        start = stop
        out = est.solve()
        t = float(data.times[stop - 1])
        outs.append(dict(
            out=out, estimate=None if est.estimate is None
            else est.estimate.copy(),
            padded=est._last_padded_poses.copy(),
            covs={d: c.copy() for d, c in est.latest_covariances.items()},
            rel=est.predict_swarm_relative(t), base=est.base_coordinates(),
            cov_frame=est.covariances_at(frame=5),
            # the reference's pose_covariance is eager JAX (tens of seconds
            # on the CPU): the port's is held to its covariances_at
            pose_cov=est.pose_covariance(2) if mod is test_mod else None))
    return outs


@pytest.fixture(scope="module")
def data():
    return sim.generate(sim.SimParams(num_drones=4, num_frames=30, seed=21))


@pytest.fixture(scope="module")
def sessions(data):
    return {name: run_session(mod, cfg, data, SOLVE_AT)
            for name, mod, cfg in (("ref", ref_mod, jconfig),
                                   ("port", test_mod, tconfig))}


@pytest.fixture(scope="module")
def reinit(data):
    return {name: run_session(mod, cfg, data, REINIT_AT, acpt_cost=1.0)
            for name, mod, cfg in (("ref", ref_mod, jconfig),
                                   ("port", test_mod, tconfig))}


def test_status_equal(sessions):
    for got, want in zip(sessions["port"], sessions["ref"]):
        for key in ("solved", "finish_init", "num_frames", "num_drones"):
            assert got["out"][key] == want["out"][key], key
    assert all(s["out"]["finish_init"] for s in sessions["ref"])


@pytest.mark.parametrize("i", range(len(SOLVE_AT)))
def test_cost(sessions, i):
    got, want = sessions["port"][i]["out"], sessions["ref"][i]["out"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-3)


@pytest.mark.parametrize("i", range(len(SOLVE_AT)))
def test_estimate(sessions, i):
    got, want = sessions["port"][i]["estimate"], \
        sessions["ref"][i]["estimate"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-3)
    yaw = np.angle(np.exp(1j * (got[..., 3] - want[..., 3])))
    np.testing.assert_allclose(yaw, 0.0, atol=1e-3)


@pytest.mark.parametrize("i", range(len(SOLVE_AT)))
def test_covariances(sessions, i):
    got, want = sessions["port"][i], sessions["ref"][i]
    assert sorted(got["covs"]) == sorted(want["covs"]) == [0, 1, 2, 3]
    for d in want["covs"]:
        np.testing.assert_allclose(got["covs"][d], want["covs"][d],
                                   rtol=0.05, atol=1e-6)
        np.testing.assert_allclose(np.diag(got["out"]["cov_diag"][d]),
                                   np.diag(want["out"]["cov_diag"][d]),
                                   rtol=0.05, atol=1e-6)
    np.testing.assert_allclose(got["pose_cov"], want["covs"][2], rtol=0.05,
                               atol=1e-6)
    for d in want["cov_frame"]:
        np.testing.assert_allclose(got["cov_frame"][d], want["cov_frame"][d],
                                   rtol=0.05, atol=1e-6)


@pytest.mark.parametrize("i", range(len(SOLVE_AT)))
def test_predictions_and_base_coordinates(sessions, i):
    got, want = sessions["port"][i], sessions["ref"][i]
    for key in ("rel", "base"):
        assert sorted(got[key]) == sorted(want[key]) == [0, 1, 2, 3]
        for d in want[key]:
            np.testing.assert_allclose(got[key][d][:3], want[key][d][:3],
                                       atol=1e-3)
            dyaw = np.angle(np.exp(1j * (got[key][d][3] - want[key][d][3])))
            assert abs(dyaw) <= 1e-3
    np.testing.assert_allclose(got["rel"][0], 0.0, atol=1e-6)


def test_forced_reinit(reinit):
    """acpt_cost=1: both solves rejected, the second a re-init whose lanes
    come from the same numpy draws; their best lanes agree."""
    for i in range(len(REINIT_AT)):
        got, want = reinit["port"][i], reinit["ref"][i]
        assert got["out"]["finish_init"] is False
        assert want["out"]["finish_init"] is False
        assert got["estimate"] is None and want["estimate"] is None
        np.testing.assert_allclose(got["out"]["cost"], want["out"]["cost"],
                                   rtol=1e-3)
        np.testing.assert_allclose(got["padded"][..., :3],
                                   want["padded"][..., :3], atol=1e-3)


def test_drive_session_records(data):
    """The session driver of estimator_entry on a short flight: one record
    per solve (window, path, timings), the hook entered around each solve,
    predictions from the first accepted solve on."""
    import contextlib

    from omniswarm_torch.estimator_entry import drive_session, frame_runs
    from omniswarm_torch.utils.telemetry import GLOBAL

    est = test_mod.SwarmEstimator(tconfig.SolverParams(
        self_id=0, max_iterations=8, max_solver_time=0.0), device="cpu")
    seen = []

    @contextlib.contextmanager
    def around(i):
        seen.append(i)
        yield

    out = drive_session(est, data, test_mod.LoopRecord, test_mod.DetRecord,
                        GLOBAL, solve_every=10, around_solve=around)
    assert seen == [0, 1, 2] and len(out["solves"]) == 3
    first = out["solves"][0]
    assert first["multi_init"] and first["lanes"] == 4
    assert frame_runs(first["frames"]) == [[0, 9]]
    for s in out["solves"]:
        assert s["linear"] == "smw" and s["pack"] == 1 and s["F"] >= 10
        assert s["host_ms"] > 0 and s["device_ms"] > 0
        assert np.isfinite(s["cost"]) and np.isfinite(s["result_ate"])
    accepted = next(i for i, s in enumerate(out["solves"])
                    if s["finish_init"])
    assert out["predictions"]["count"] == 30 - 10 * (accepted + 1) + 1
    assert out["predictions"]["finite"]
    assert out["predictions"]["self_max_abs"] <= 1e-6
    assert out["final"]["relative_ate"] < 0.5
    assert sorted(out["final"]["cov_diag"]) == [0, 1, 2, 3]
