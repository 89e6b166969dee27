"""``node_entry.process_swarm``: the drone processes' scenario and command
lines, on the CPU without starting a node.

The default stays ``tests/test_multiprocess.py``'s swarm (2 drones x 16
frames, seed 55, radius 2-4 m, world seed 7, 0.12 wall seconds a frame):
the scenario is the JAX simulator's bit for bit, and a stand-in drone
program records the flags each process is started with. The 5 x 100 swarm
that runs on the card draws its flight the same way.

The JAX anchor of the 5 x 100 swarm (the reference's own
``tools/drone_process.py`` processes on the same scenario, on the CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_process_swarm.py \\
        --anchor 5 100
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch.node_entry import process_swarm, swarm_scenario
from omniswarm_tpu import sim

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

# a drone process that only writes its flags into its output
STAND_IN = textwrap.dedent("""
    import sys
    import numpy as np
    argv = sys.argv[1:]
    out = argv[argv.index("--out") + 1]
    np.savez(out, argv=np.asarray(argv), solved=np.asarray(False),
             cost=np.asarray(np.nan), estimate=np.zeros((0,)),
             loops_found=np.asarray(1), loops_received=np.asarray(2))
""")


@pytest.mark.parametrize("drones,frames", [(2, 16), (5, 100)])
def test_scenario_is_the_references(drones, frames):
    want = sim.generate(sim.SimParams(num_drones=drones, num_frames=frames,
                                      seed=55, radius_range=(2.0, 4.0)))
    got = swarm_scenario(drones, frames)
    for name in ("gt", "vio", "ranges", "range_valid", "times"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_default_swarm_is_test_multiprocess(tmp_path):
    """The default: 2 processes, the 2 x 16 scenario, 0.12 s a frame,
    the port's module on the given device."""
    script = tmp_path / "stand_in.py"
    script.write_text(STAND_IN)
    res = process_swarm(tmp_path / "run", port=17999, device="cpu",
                        program=[sys.executable, str(script)],
                        timeout_s=60)
    rows = res["processes"]
    assert [r["drone"] for r in rows] == [0, 1]
    for r in rows:
        assert r["returncode"] == 0, r["tail"]
        assert (r["loops_found"], r["loops_received"]) == (1, 2)
        argv = list(np.load(tmp_path / "run" / f"out{r['drone']}.npz")
                    ["argv"])
        assert argv == ["--scenario", str(tmp_path / "run/scenario.npz"),
                        "--drone-id", str(r["drone"]), "--out",
                        str(tmp_path / f"run/out{r['drone']}.npz"),
                        "--port", "17999", "--step-wall", "0.12"]
    scen = np.load(tmp_path / "run" / "scenario.npz")
    assert scen["gt"].shape == (16, 2, 4)
    assert int(scen["world_seed"]) == 7


# a drone process that solved above acpt_cost: no estimate, its final
# solve's poses the ground truth at its keyframes, its drones in the
# window's order (1, 0)
SOLVED = textwrap.dedent("""
    import sys
    import numpy as np
    argv = sys.argv[1:]
    out = argv[argv.index("--out") + 1]
    gt = np.load(argv[argv.index("--scenario") + 1])["gt"]
    kf = np.arange(0, len(gt), 2)
    ids = np.asarray([1, 0])
    np.savez(out, solved=np.asarray(True), cost=np.asarray(105.0),
             estimate=np.zeros((0,)), final_poses=gt[kf][:, ids],
             window_ids=ids, kf_times=kf.astype(float),
             loops_found=np.asarray(1), loops_received=np.asarray(2))
""")


def test_ate_reads_the_final_poses_without_an_estimate(tmp_path):
    from omniswarm_torch.node_entry import swarm_bars

    script = tmp_path / "solved.py"
    script.write_text(SOLVED)
    res = process_swarm(tmp_path / "run", port=17999, device="cpu",
                        program=[sys.executable, str(script)],
                        timeout_s=60)
    for r in res["processes"]:
        assert r["returncode"] == 0, r["tail"]
        assert r["solved"] and not r["estimated"] and r["cost"] == 105.0
        assert r["relative_ate"] == pytest.approx(0.0, abs=1e-9)
    assert swarm_bars(res, dict(solved=[0, 1], worst_ate=0.01)) == []


def test_swarm_kills_every_process_past_its_deadline(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        argv = sys.argv[1:]
        with open(argv[argv.index("--out") + 1] + ".pid", "w") as f:
            f.write(str(os.getpid()))
        time.sleep(60)
    """))
    with pytest.raises(subprocess.TimeoutExpired):
        process_swarm(tmp_path / "run", port=17999, device="cpu",
                      drones=3, frames=4,
                      program=[sys.executable, str(script)], timeout_s=3)
    pids = [int((tmp_path / f"run/out{d}.npz.pid").read_text())
            for d in range(3)]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_default_program_is_the_ports_module(monkeypatch, tmp_path):
    started = []

    class Done:
        returncode = 1

        def __init__(self, argv, **kw):
            started.append(argv)

        def communicate(self, timeout):
            return "", None

        def poll(self):
            return 1

    import omniswarm_torch.node_entry as ne

    monkeypatch.setattr(ne.subprocess, "Popen", Done)
    res = ne.process_swarm(tmp_path, port=17999, device="cpu", drones=5,
                           frames=6)
    assert len(res["processes"]) == 5
    assert started[3][:5] == [sys.executable, "-m",
                              "omniswarm_torch.runtime.drone_process",
                              "--device", "cpu"]
    assert started[3][-2:] == ["--step-wall", "0.12"]


def _row(d, solved=True, ate=0.05, found=3, received=4, rc=0,
         estimated=True):
    return dict(drone=d, returncode=rc, solved=solved, estimated=estimated,
                relative_ate=ate, loops_found=found, loops_received=received,
                tail="")


@pytest.mark.parametrize("case,rows,bad", [
    ("pass", [_row(0), _row(1, solved=False, ate=None)], 0),
    ("exit", [_row(0), _row(1, rc=1)], 1),
    ("no loops found", [_row(0, found=0), _row(1, found=0)], 1),
    ("no loops received", [_row(0, received=0), _row(1, received=0)], 1),
    ("over the test's bar", [_row(0, ate=0.31), _row(1)], 1),
    ("over the anchor", [_row(0, ate=0.08), _row(1)], 1),
    ("solved there, not here", [_row(0, solved=False, ate=None),
                                _row(1)], 1),
    ("solved without an estimate", [_row(0, estimated=False),
                                    _row(1, estimated=False)], 0),
    ("solved without final poses", [_row(0, ate=None), _row(1)], 1),
    ("over the anchor without an estimate",
     [_row(0, ate=0.08, estimated=False), _row(1)], 1),
])
def test_swarm_bars(case, rows, bad):
    from omniswarm_torch.node_entry import swarm_bars

    anchor = dict(solved=[0], worst_ate=0.055)
    got = swarm_bars(dict(processes=rows), anchor)
    assert len(got) == bad, (case, got)


# the reference's tools/drone_process.py, run as it is, whose output also
# holds its final solve's poses (as the port's drone process writes them)
FINAL_POSES = textwrap.dedent("""
    import runpy
    import sys
    import numpy as np
    repo, script = sys.argv[1], sys.argv[2]
    sys.path.insert(0, repo)
    sys.argv = [script, *sys.argv[3:]]
    from omniswarm_tpu.swarm import node
    last = {}
    solve = node.DroneNode.solve
    def keep(self, t=0.0):
        out = last["out"] = solve(self, t)
        last["est"] = self.estimator
        return out
    node.DroneNode.solve = keep
    savez = np.savez
    def with_final_poses(path, **arrays):
        est = last["est"]
        arrays["final_poses"] = (
            np.asarray(est._last_padded_poses)[:est._last_num_window]
            if last["out"].get("solved") else np.zeros((0,)))
        savez(path, **arrays)
    np.savez = with_final_poses
    runpy.run_path(script, run_name="__main__")
""")


def reference_anchor(drones: int, frames: int, port: int) -> dict:
    """The reference's drone processes on the scenario, on the CPU."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        wrapper = Path(tmp) / "final_poses.py"
        wrapper.write_text(FINAL_POSES)
        res = process_swarm(
            Path(tmp) / "run", port=port, drones=drones, frames=frames,
            program=[sys.executable, str(wrapper), str(REPO),
                     str(REPO / "tools/drone_process.py")],
            timeout_s=3600)
    for row in res["processes"]:
        if row["returncode"] == 0:
            row.pop("tail")
    return dict(drones=drones, frames=frames, **res)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--anchor", nargs=2, type=int, required=True,
                    metavar=("DRONES", "FRAMES"))
    ap.add_argument("--port", type=int, default=17973)
    args = ap.parse_args()
    print(json.dumps(reference_anchor(*args.anchor, args.port)))
