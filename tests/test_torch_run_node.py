"""The production node (``omniswarm_torch.runtime.run_node``) on the CPU.

The stream of ``tests/test_run_node.py`` (3 drones x 20 frames, seed 99;
``init_z_movement`` 0.05, ``pcm_redundant``, ``max_iterations`` 40, a solve
every 10th frame) as the node's JSON lines, with the simulator's
detections as ``det`` lines and ``max_solver_time`` 0 (iteration counts
that do not depend on the host's speed), goes through ``NodeLoop``:

- with the JAX package's estimator and classes (its ``NodeKit``) and with
  the port's, both inline: the solve and predict lines agree within the
  bars of ``tests/test_torch_estimator_solve.py`` (status equal, cost
  rtol 1e-3, poses 1e-3), and each solve's window is the same;
- the port's threaded, paced loop bit for bit equal to its inline loop;
- ``python -m omniswarm_torch.runtime.run_node --no-udp --device cpu`` in
  a subprocess, as ``test_run_node_process`` runs the reference's.

Also the config's YAML round trip (``test_config_yaml_roundtrip``'s
checks, and equal to the reference's parse) and the node flight of
``node_entry`` (the static anchor).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from omniswarm_torch import config as tconfig
from omniswarm_torch.node_entry import (drive_paced, flight_lines,
                                        hold_static, node_flight)
from omniswarm_torch.runtime.run_node import NodeKit, port_kit
from omniswarm_torch.swarm import estimator as test_mod
from omniswarm_tpu import config as jconfig
from omniswarm_tpu import sim
from omniswarm_tpu.swarm import estimator as ref_mod

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = dict(num_drones=3, num_frames=20, seed=99)
SOLVER = dict(self_id=0, init_z_movement=0.05, pcm_redundant=True,
              max_iterations=40, force_freq=0.1, max_solver_time=0.0)


def ref_kit() -> NodeKit:
    from omniswarm_tpu.swarm.comm import InlierSetPacket
    from omniswarm_tpu.swarm.proxy import (FusedDownlink, LocalProxy,
                                           NodeDetectedPacket)

    return NodeKit(ref_mod.DetRecord, LocalProxy, FusedDownlink,
                   NodeDetectedPacket, InlierSetPacket)


@pytest.fixture(scope="module")
def stream():
    data = node_flight(sim, STREAM, static_drone=None)
    return data, flight_lines(data)


def run(mod, cfg, kit, lines, threaded):
    kw = {} if mod is ref_mod else dict(device="cpu")
    params = cfg.SolverParams(**SOLVER)
    est = mod.SwarmEstimator(params, rng_seed=0, **kw)
    out = drive_paced(est, kit, params, lines, threaded=threaded)
    out["estimate"] = est.estimate
    return out


@pytest.fixture(scope="module")
def sessions(stream):
    _, lines = stream
    return dict(
        ref=run(ref_mod, jconfig, ref_kit(), lines, threaded=False),
        port=run(test_mod, tconfig, port_kit(), lines, threaded=False),
        port_threaded=run(test_mod, tconfig, port_kit(), lines,
                          threaded=True))


def by_type(records, kind):
    return [r for r in records if r["type"] == kind]


def test_config_yaml_roundtrip(tmp_path):
    path = os.path.join(REPO, "configs", "swarm5.yaml")
    cfg = tconfig.SwarmConfig.from_yaml(path)
    assert cfg.self_id == 0
    assert cfg.solver.max_frame_number == 100
    assert cfg.nodes[4].is_static and not cfg.nodes[4].has_vo
    assert cfg.nodes[0].antenna_pos == (0.0, 0.0, 0.1)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig.SwarmConfig.from_yaml(path))
    out = tmp_path / "cfg.yaml"
    cfg.to_yaml(str(out))
    assert dataclasses.asdict(tconfig.SwarmConfig.from_yaml(str(out))) == \
        dataclasses.asdict(cfg)


def test_node_loop_matches_reference(sessions):
    got, want = sessions["port"], sessions["ref"]
    assert got["windows"] == want["windows"] and len(want["windows"]) == 2
    gs, ws = by_type(got["records"], "solve"), by_type(want["records"],
                                                       "solve")
    assert [s["t"] for s in gs] == [s["t"] for s in ws] == [0.0, 10.0]
    assert ws[1]["solved"]
    for g, w in zip(gs, ws):
        assert g.keys() == w.keys()
        for key in ("solved", "reason", "finish_init", "num_frames",
                    "num_drones"):
            assert g.get(key) == w.get(key), key
        if "cost" in w:
            np.testing.assert_allclose(g["cost"], w["cost"], rtol=1e-3)
        for d in w.get("cov_diag", {}):
            np.testing.assert_allclose(g["cov_diag"][d], w["cov_diag"][d],
                                       rtol=0.05, atol=1e-6)
    gp, wp = by_type(got["records"], "predict"), by_type(want["records"],
                                                         "predict")
    # t = 10 .. 19, then the final prediction at the last solve's tick
    assert [p["t"] for p in gp] == [p["t"] for p in wp] == \
        [float(t) for t in range(10, 20)] + [10.0]
    for g, w in zip(gp, wp):
        assert sorted(g["poses"]) == sorted(w["poses"]) == ["0", "1", "2"]
        for d in w["poses"]:
            a, b = np.asarray(g["poses"][d]), np.asarray(w["poses"][d])
            np.testing.assert_allclose(a[:3], b[:3], atol=1e-3)
            assert abs(np.angle(np.exp(1j * (a[3] - b[3])))) <= 1e-3
    np.testing.assert_allclose(got["estimate"][..., :3],
                               want["estimate"][..., :3], atol=1e-3)


def test_threaded_paced_loop_bit_equal_inline(sessions):
    a, b = sessions["port_threaded"], sessions["port"]
    assert a["records"] == b["records"] and a["windows"] == b["windows"]
    np.testing.assert_array_equal(a["estimate"], b["estimate"])
    loop = a["loop"]
    assert loop.dispatched == 2 and loop.skipped_busy == 0
    assert len(loop.solve_wall_ms) == 1
    cadence = loop.cadence()
    assert cadence["predict_gap_ms"]["idle"]["count"] == 9


def test_run_node_cli(tmp_path, stream):
    _, lines = stream
    cfgp = tmp_path / "cfg.yaml"
    cfgp.write_text("self_id: 0\nsolver: {init_z_movement: 0.05, "
                    "pcm_redundant: true, max_iterations: 40, "
                    "force_freq: 0.1}\n")
    proc = subprocess.run(
        [sys.executable, "-m", "omniswarm_torch.runtime.run_node",
         "--config", str(cfgp), "--no-udp", "--device", "cpu"],
        input="\n".join(lines), capture_output=True, text=True, cwd=REPO,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    outs = [json.loads(line) for line in proc.stdout.splitlines() if line]
    solves = by_type(outs, "solve")
    predicts = by_type(outs, "predict")
    assert any(s.get("solved") for s in solves), solves
    assert len(predicts[-1]["poses"]) == 3
    cadence = json.loads(proc.stderr.strip().splitlines()[-1])
    assert cadence["type"] == "cadence" and cadence["dispatched"] == 2


def test_node_flight_holds_the_anchor():
    data = sim.generate(sim.SimParams(num_drones=3, num_frames=6, seed=2))
    held = hold_static(data, 2)
    np.testing.assert_array_equal(held.gt[:, 2], np.tile(data.gt[0, 2],
                                                         (6, 1)))
    np.testing.assert_array_equal(held.vio[:, 2], np.tile(data.vio[0, 2],
                                                          (6, 1)))
    np.testing.assert_array_equal(held.ranges[:, :2, :2],
                                  data.ranges[:, :2, :2])
    true_d = np.linalg.norm(held.gt[:, :2, :3] - held.gt[:, 2:, :3],
                            axis=-1)
    assert np.abs(held.ranges[:, :2, 2] - true_d).max() < 0.5
    np.testing.assert_array_equal(held.ranges[:, 2, :2],
                                  held.ranges[:, :2, 2])
    assert all(2 not in (d.drone_a, d.drone_b) for d in held.detections)
    lines = flight_lines(held)
    assert json.loads(lines[-1]) == {"type": "quit"}
    assert sum(json.loads(x)["type"] == "frame" for x in lines) == 6


def test_paced_sessions_on_the_node_flight():
    """node_entry's paced pair (the card phase's first half) on the CPU,
    cut to 20 frames: bit-equal, predictions of all 5 drones taken with no
    solve in flight. (At 20 frames raw VIO has barely drifted; the card
    phase holds the ATE against it at 150.)"""
    from omniswarm_torch.node_entry import paced_sessions

    res = paced_sessions(device="cpu", frames=20)
    assert res["bit_equal"]
    thr = res["threaded"]
    assert [s["t"] for s in thr["solves"]] == [0.0, 10.0]
    assert thr["solves"][1]["solved"] and thr["k1_launches"] == 0
    assert np.isfinite(thr["relative_ate"])
    assert thr["last_prediction_drones"] == 5
    gaps = thr["cadence"]["predict_ms"]
    assert gaps["in_flight"]["count"] == 0 and gaps["idle"]["count"] > 0
