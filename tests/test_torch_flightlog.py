"""The port's flight-log replay against ``omniswarm_tpu/io/flightlog.py``.

The reference's flight logs are not in the repository, so each test writes
CSV logs in the documented column layout (``ts, ctrl_mode, pos(3), vel(3),
rpy(3), pos_sp(3), vel_sp(3), acc_sp(3), rpy_sp(3), thr_sp``) from a
seeded trajectory, and both packages read and replay them: the parsed
logs, the resampled poses and the replayed datasets must be equal, draw
for draw (both replays draw from one numpy ``Generator`` of the seed).
"""
import dataclasses

import numpy as np
import pytest
import torch

from omniswarm_torch.io import flightlog as tlog
from omniswarm_tpu.io import flightlog as jlog

torch.set_num_threads(1)


def write_log(path, seed: int, n: int = 400, rate: float = 50.0):
    rng = np.random.default_rng(seed)
    ts = 100.0 + np.arange(n) / rate
    th = 0.3 * (ts - ts[0]) + seed
    pos = np.stack([2.0 * np.cos(th), 2.0 * np.sin(th),
                    1.0 + 0.2 * np.sin(0.5 * th)], 1)
    vel = np.gradient(pos, axis=0) * rate
    yaw = np.arctan2(np.sin(th + np.pi / 2), np.cos(th + np.pi / 2))
    rpy = np.stack([0.05 * rng.normal(size=n), 0.05 * rng.normal(size=n),
                    yaw], 1)
    sp = rng.normal(size=(n, 12))
    cols = [ts[:, None], np.full((n, 1), 2.0), pos, vel, rpy, sp,
            rng.uniform(0.4, 0.6, (n, 1))]
    np.savetxt(path, np.concatenate(cols, 1), delimiter=",", fmt="%.9f")
    return ts


@pytest.fixture
def logs(tmp_path):
    paths = []
    for d in range(3):
        p = tmp_path / f"flight{d}.csv"
        write_log(p, seed=d)
        paths.append(str(p))
    return paths


def same_log(a, b):
    for f in ("ts", "pos", "vel", "rpy"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("kw", [{}, dict(zero_yaw=True),
                                dict(yaw_only=False, t_start=101.0,
                                     t_end=105.0)])
def test_parse_flight_csv_matches(logs, kw):
    got = tlog.parse_flight_csv(logs[0], **kw)
    same_log(got, jlog.parse_flight_csv(logs[0], **kw))
    assert got.pos.shape[1] == 3 and got.pose4().shape == (len(got.ts), 4)
    np.testing.assert_array_equal(
        got.pose4(), jlog.parse_flight_csv(logs[0], **kw).pose4())


def test_resample_matches(logs):
    log_t = tlog.parse_flight_csv(logs[1])
    log_j = jlog.parse_flight_csv(logs[1])
    for offset in (None, np.array([2.5, 0.0, 0.0])):
        np.testing.assert_array_equal(
            tlog.resample(log_t, 100.3, 0.5, 12, offset=offset),
            jlog.resample(log_j, 100.3, 0.5, 12, offset=offset))


@pytest.mark.parametrize("synth_loops", [False, True])
def test_replay_dataset_matches_draw_for_draw(logs, synth_loops):
    kw = dict(num_frames=14, dt=0.5, seed=3, synth_loops=synth_loops,
              loop_every=3, loop_max_distance=4.0,
              uwb_bias=np.full((3, 3), 0.2), uwb_scale=np.full((3, 3), 0.95))
    pairs = [(p, 0.2 * i) for i, p in enumerate(logs)]
    got = tlog.replay_dataset(pairs, **kw)
    want = jlog.replay_dataset(pairs, **kw)
    for f in ("times", "gt", "vio", "ranges", "range_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)
    assert len(got.loops) == len(want.loops)
    if synth_loops:
        assert got.loops
    for a, b in zip(got.loops, want.loops):
        assert (a.frame_a, a.drone_a, a.frame_b, a.drone_b) == \
            (b.frame_a, b.drone_a, b.frame_b, b.drone_b)
        np.testing.assert_array_equal(a.dpose, b.dpose)
    assert got.detections == [] and got.gt.shape == (14, 3, 4)
