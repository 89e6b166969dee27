"""``python -m omniswarm_torch.tools.replay_eval`` against the reference's
``tools/replay_eval.py`` on the same CSV flight logs.

The reference's flight logs are not in the repository, so the logs are
written in its CSV layout from the port's simulator
(``replay_eval.write_sim_logs``, as ``tests/test_torch_flightlog.py``
writes its logs); both tools replay them through their own estimator (the
reference's on JAX's CPU backend, the port's with ``--device cpu``) and
write ``summary.json``. Every position value of the two summaries lies
within 0.01 m, every yaw RMSE within 1e-3 rad, and both run the same solves
over the same windows.

The estimator caps a solve's iterations at ``max_solver_time`` (0.5 s)
over the ms an iteration it measured, in steps of 25 with 25 the least, so
the two packages' iteration counts, and their summaries, followed the
host's load (a pair's relative ATE 0.011 m apart in one run of three).
Both tools run with ``max_solver_time`` 1e-6 s, so every solve after the
second gets the least budget, 25, on any host.
"""
import functools
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch.tools import replay_eval

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# the summaries' position values (ATE, relative ATE) split by up to 2.5e-3
# m on these logs, the yaw RMSEs by up to 3.3e-5 rad
ATOL = 0.01
YAW_ATOL = 1e-3


def flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    paths = replay_eval.write_sim_logs(str(d), drones=3, seconds=30.0)
    return [f"{p}:{2.0 * i}" for i, p in enumerate(paths)]


def test_write_sim_logs_layout(logs):
    from omniswarm_tpu.io import flightlog as jlog

    log = jlog.parse_flight_csv(logs[0].rsplit(":", 1)[0])
    assert len(log.ts) == 1500 and log.pos.shape == (1500, 3)
    np.testing.assert_allclose(np.diff(log.ts), 0.02, atol=1e-9)
    assert np.all(log.rpy[:, :2] == 0.0)


def least_time_budget(monkeypatch, module):
    """``module.SolverParams`` built with ``max_solver_time=1e-6``."""
    monkeypatch.setattr(module, "SolverParams", functools.partial(
        module.SolverParams, max_solver_time=1e-6))


def test_replay_matches_reference(logs, tmp_path, capsys, monkeypatch):
    from omniswarm_tpu import config as jconfig

    least_time_budget(monkeypatch, jconfig)  # the reference imports it late
    least_time_budget(monkeypatch, replay_eval)
    argv = ["--logs", *logs, "--frames", "20", "--loops"]
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import replay_eval as jtool
    finally:
        sys.path.remove(str(ROOT / "tools"))
    monkeypatch.setattr(sys, "argv", ["replay_eval.py", *argv, "--out",
                                      str(tmp_path / "jax")])
    jtool.main()
    printed = capsys.readouterr().out
    ref_windows = [int(w) for w in re.findall(r"'num_frames': (\d+)",
                                              printed)]
    ref_solved = re.findall(r"'solved': (\w+)", printed)

    got = replay_eval.main([*argv, "--out", str(tmp_path / "port"),
                            "--device", "cpu"])
    # the reference prints every solve but the final one
    assert [s["num_frames"] for s in got["solves"][:-1]] == ref_windows
    assert [str(s["solved"]) for s in got["solves"][:-1]] == ref_solved
    assert len(ref_windows) == 2 and all(s["solved"] for s in got["solves"])
    want = dict(flat(json.loads((tmp_path / "jax/summary.json").read_text())))
    have = dict(flat(json.loads(
        (tmp_path / "port/summary.json").read_text())))
    assert have.keys() == want.keys()
    for key, value in want.items():
        bar = YAW_ATOL if key.endswith("yaw_rmse") else ATOL
        assert abs(have[key] - value) <= bar, (key, have[key], value)
    assert got["summary"]["mean_relative_ate"] == have["mean_relative_ate"]
    assert got["relative_ate"] < got["vio_relative_ate"]


def test_replay_refuses_reference_output(logs):
    with pytest.raises(SystemExit):
        replay_eval.main(["--logs", *logs, "--out", str(ROOT / "replay_out"),
                          "--device", "cpu"])
