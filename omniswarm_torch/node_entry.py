"""The production node end to end: a scripted flight through
``runtime.run_node``.

The flight is ``estimator_entry.SESSION``'s (5 drones x 150 frames, seed
0) with drone 4 held still at its first pose, because
``configs/swarm5.yaml`` declares it a static UWB anchor with no VIO and
no camera: its ranges are drawn again from its fixed position with the
simulator's noise (seed 1), and the detections it makes or is the target
of are dropped. It is encoded as the node's JSON lines (``flight_lines``):
per frame a ``frame`` line (every drone's VIO, the valid ranges), a
``vio`` line for the self drone and a ``det`` line per detection. Loop
edges are not fed: the stdin protocol carries none (a node gets loops only
over ``LoopNet``).

- ``paced_sessions``: the flight through ``NodeLoop`` twice, a solve every
  ``SOLVE_EVERY``-th frame (``force_freq`` 0.1; the same cut as
  ``estimator_entry``) and ``max_solver_time`` 0 (iteration counts that do
  not depend on the card's speed): once on the worker thread, waiting for
  each solve before the tick goes on, once inline. Their records must be
  equal bit for bit.
- ``free_running``: ``python -m omniswarm_torch.runtime.run_node`` in a
  subprocess at the config's own cadence, fed ``fps`` frames a wall
  second; returns its lines, its cadence record and its exit code.
- ``process_swarm``: drones as processes of their own
  (``runtime.drone_process``) over loopback multicast, 2 x 16 frames by
  default; ``--swarm D F`` runs D drones x F frames and prints its JSON.

    python -m omniswarm_torch.node_entry            # on the GPU
    python -m omniswarm_torch.node_entry --swarm 5 100   # twice, to bars
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "swarm5.yaml"
STATIC_DRONE = 4
SOLVE_EVERY = 10


def hold_static(data, drone: int, seed: int = 1):
    """``data`` with ``drone`` held at its first pose: ground truth and VIO
    constant, its ranges redrawn from the fixed position (symmetric noise
    of the simulator's std), the detections it takes part in dropped."""
    from omniswarm_torch.sim.simulator import SimData

    rng = np.random.default_rng(seed)
    gt, vio = data.gt.copy(), data.vio.copy()
    gt[:, drone] = gt[0, drone]
    vio[:, drone] = vio[0, drone]
    true_d = np.linalg.norm(gt[:, :, :3] - gt[:, drone:drone + 1, :3],
                            axis=-1)
    noise = rng.normal(0, data.params.uwb_noise_std, size=true_d.shape)
    meas = np.maximum(data.params.uwb_scale * true_d + noise
                      + data.params.uwb_bias, 0.0)
    ranges = data.ranges.copy()
    ranges[:, :, drone] = meas
    ranges[:, drone, :] = meas
    ranges[:, drone, drone] = 0.0
    dets = [d for d in data.detections if drone not in (d.drone_a, d.drone_b)]
    return SimData(params=data.params, times=data.times, gt=gt, vio=vio,
                   ranges=ranges, range_valid=data.range_valid,
                   loops=list(data.loops), detections=dets)


def node_flight(sim, session: Optional[dict] = None,
                static_drone: Optional[int] = STATIC_DRONE):
    """The flight (``sim``: the simulator module of either package)."""
    from omniswarm_torch.estimator_entry import SESSION

    data = sim.generate(sim.SimParams(**(session or SESSION)))
    if static_drone is not None:
        data = hold_static(data, static_drone)
    return data


def flight_lines(data, self_id: int = 0) -> List[str]:
    """The flight as the node's JSON input lines, ``quit`` last; one list
    of lines a frame is ``frame_lines``."""
    return [line for frame in frame_lines(data, self_id) for line in frame] \
        + [json.dumps({"type": "quit"})]


def frame_lines(data, self_id: int = 0) -> List[List[str]]:
    F, D = data.gt.shape[:2]
    dets_at = {}
    for det in data.detections:
        dets_at.setdefault(det.frame, []).append(det)
    out = []
    for k in range(F):
        t = float(data.times[k])
        vec = lambda a: [float(x) for x in a]
        lines = [json.dumps({
            "type": "frame", "t": t,
            "vio": {str(d): vec(data.vio[k, d]) for d in range(D)},
            "ranges": [[a, b, float(data.ranges[k, a, b])]
                       for a in range(D) for b in range(D)
                       if a != b and data.range_valid[k, a, b]]}),
            json.dumps({"type": "vio", "t": t,
                        "pose": vec(data.vio[k, self_id])})]
        for det in dets_at.get(k, ()):
            lines.append(json.dumps({
                "type": "det", "t": t, "source": int(det.drone_a),
                "target": int(det.drone_b), "direction": vec(det.direction),
                "inv_dep": float(det.inv_dep)}))
        out.append(lines)
    return out


def paced_config():
    """The config of the paced sessions: ``CONFIG``'s, with a solve every
    ``SOLVE_EVERY``-th frame of the flight's 1 s period and no wall-clock
    iteration budget."""
    from omniswarm_torch.config import SwarmConfig

    cfg = SwarmConfig.from_yaml(str(CONFIG))
    cfg.solver.force_freq = 1.0 / SOLVE_EVERY
    cfg.solver.max_solver_time = 0.0
    return cfg


def drive_paced(estimator, kit, params, lines, *, threaded: bool,
                self_id: int = 0) -> dict:
    """Feed ``lines`` through a ``NodeLoop`` over ``estimator`` (either
    package's, with its ``NodeKit``); ``threaded`` solves on the worker
    thread and waits for each, else inline. Returns the output records,
    each solve's window (keyframe times at its dispatch) and the loop."""
    from omniswarm_torch.runtime.run_node import NodeLoop, run_lines

    records, windows = [], []

    class Recording(NodeLoop):
        def _dispatch(self, t):
            windows.append([float(kf.t) for kf in self.estimator.window])
            super()._dispatch(t)

    loop = Recording(estimator, kit, self_id=self_id,
                     force_freq=params.force_freq,
                     predict_freq=params.predict_freq, threaded=threaded,
                     paced=threaded, emit=records.append)
    run_lines(loop, lines)
    return dict(records=records, windows=windows, loop=loop)


def session_summary(run: dict, estimator, data) -> dict:
    """A paced session's solves, predictions and final relative ATE beside
    raw VIO's on the same keyframes."""
    from omniswarm_torch.estimator_entry import relative_ate, window_frames
    from omniswarm_torch.eval.metrics import mean_relative_ate

    solves = [r for r in run["records"] if r["type"] == "solve"]
    preds = [r for r in run["records"] if r["type"] == "predict"]
    out = dict(solves=solves, windows=run["windows"],
               predictions=len(preds),
               last_prediction_drones=len(preds[-1]["poses"]) if preds
               else 0, relative_ate=None, vio_relative_ate=None)
    if estimator.estimate is not None:
        frames = window_frames(estimator, data.times,
                               len(estimator.estimate))
        out["relative_ate"] = relative_ate(estimator.estimate, frames,
                                           data.gt)
        out["vio_relative_ate"] = float(mean_relative_ate(
            data.vio[frames], data.gt[frames]))
    return out


def paced_sessions(device="cuda", *, frames: Optional[int] = None) -> dict:
    """The flight twice on ``device`` (threaded and inline, see the module
    docstring); K1's launches counted on the threaded run. ``frames`` cuts
    the flight."""
    from omniswarm_torch import sim
    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.estimator_entry import SESSION
    from omniswarm_torch.runtime.run_node import port_kit
    from omniswarm_torch.solver.fused_level import fused_reduction_level
    from omniswarm_torch.swarm import SwarmEstimator

    dev = resolve_device(device)
    session = dict(SESSION, num_frames=frames or SESSION["num_frames"])
    data = node_flight(sim, session)
    lines = flight_lines(data)
    out = {}
    for name, threaded in (("threaded", True), ("inline", False)):
        cfg = paced_config()
        est = SwarmEstimator(cfg.solver, node_configs=cfg.nodes,
                             device=dev)
        k1 = fused_reduction_level.launches
        t0 = time.perf_counter()
        run = drive_paced(est, port_kit(), cfg.solver, lines,
                          threaded=threaded, self_id=cfg.self_id)
        out[name] = dict(session_summary(run, est, data),
                         seconds=time.perf_counter() - t0,
                         k1_launches=fused_reduction_level.launches - k1,
                         cadence=run["loop"].cadence(),
                         records=run["records"])
    out["bit_equal"] = (out["threaded"]["records"] == out["inline"]["records"]
                        and out["threaded"]["windows"]
                        == out["inline"]["windows"])
    return out


def free_running(lines_by_frame: List[List[str]], *, fps: float,
                 device: str = "cuda", timeout_s: float = 300.0) -> dict:
    """``run_node.main`` in a subprocess (``--no-udp``), fed one frame's
    lines every 1 / ``fps`` wall seconds from its ``ready`` line on, then
    ``quit``. Returns its output records, its cadence record (stderr), its
    exit code and the wall seconds from the first line to its exit."""
    cmd = [sys.executable, "-m", "omniswarm_torch.runtime.run_node",
           "--config", str(CONFIG), "--no-udp", "--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    out_lines, err_lines = [], []

    def reader(stream, sink):
        for line in stream:
            sink.append(line)

    threads = [threading.Thread(target=reader, args=(s, k), daemon=True)
               for s, k in ((proc.stdout, out_lines),
                            (proc.stderr, err_lines))]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    try:
        # the pace starts once the node reads its input
        while not any(line.startswith('{"type": "ready"}')
                      for line in err_lines):
            if proc.poll() is not None or \
                    time.perf_counter() - t0 > timeout_s:
                raise RuntimeError("the node did not start: "
                                   + "".join(err_lines[-20:]))
            time.sleep(0.05)
        t0 = time.perf_counter()
        for k, lines in enumerate(lines_by_frame):
            delay = t0 + k / fps - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            proc.stdin.write("\n".join(lines) + "\n")
            proc.stdin.flush()
        proc.stdin.write(json.dumps({"type": "quit"}) + "\n")
        proc.stdin.close()
        rc = proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for th in threads:
        th.join(timeout=10)
    records = [json.loads(line) for line in out_lines if line.strip()]
    cadence = [json.loads(line) for line in err_lines
               if line.startswith('{"type": "cadence"')]
    return dict(returncode=rc, records=records,
                cadence=cadence[-1] if cadence else None,
                stderr_tail="".join(err_lines[-20:]),
                seconds=time.perf_counter() - t0)


def free_running_summary(run: dict, final_t: float) -> dict:
    """The free-running session's numbers: solves dispatched, ticks skipped
    as busy, solves that ran (``solved``) and under ``acpt_cost``
    (``finish_init``), the last solved tick against the flight's final t,
    the last prediction's drone count, and the cadence record."""
    solves = [r for r in run["records"] if r.get("type") == "solve"]
    solved = [r for r in solves if r.get("solved")]
    preds = [r for r in run["records"] if r.get("type") == "predict"]
    return dict(
        returncode=run["returncode"], seconds=run["seconds"],
        solve_lines=len(solves), solved=len(solved),
        under_acpt=sum(bool(r.get("finish_init")) for r in solved),
        last_solved_t=max((r["t"] for r in solved), default=None),
        final_t=final_t, predictions=len(preds),
        last_prediction_drones=len(preds[-1]["poses"]) if preds else 0,
        cadence=run["cadence"])


def swarm_scenario(drones: int = 2, frames: int = 16):
    """The drone processes' flight (seed 55, radius 2-4 m), as
    ``tests/test_multiprocess.py`` draws it at 2 drones x 16 frames."""
    from omniswarm_torch import sim

    return sim.generate(sim.SimParams(num_drones=drones, num_frames=frames,
                                      seed=55, radius_range=(2.0, 4.0)))


# wall seconds a simulated frame of the drone processes
# (tests/test_multiprocess.py's pace: it lets the datagrams flow)
STEP_WALL = 0.12


def process_swarm(out_dir, *, port: int, device: str = "cuda",
                  drones: int = 2, frames: int = 16,
                  timeout_s: float = 300.0,
                  program: Optional[List[str]] = None) -> dict:
    """``drones`` processes of ``runtime.drone_process`` over loopback
    multicast on ``port`` (default ``tests/test_multiprocess.py``'s
    scenario: 2 drones x 16 frames of ``swarm_scenario``, world seed 7,
    ``STEP_WALL`` wall seconds a frame), each writing its estimate and its
    final solve's poses under ``out_dir``. ``program`` is the command that
    starts one drone process before its scenario flags (default: the
    port's module on ``device``). Returns, per process, its exit code,
    whether its final solve ran (``solved``) and its cost, whether it
    wrote an estimate (``estimated``: some solve's cost passed
    ``acpt_cost``), the relative ATE of its final solve's poses against
    ground truth whatever their cost (None without them) and its loops
    found and received; and the wall seconds. A process still running at
    ``timeout_s`` is killed, and so is every other."""
    from omniswarm_torch.eval import metrics

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = swarm_scenario(drones, frames)
    scenario = out_dir / "scenario.npz"
    np.savez(scenario, gt=data.gt, vio=data.vio, ranges=data.ranges,
             range_valid=data.range_valid, times=data.times,
             world_seed=np.asarray(7))
    if program is None:
        program = [sys.executable, "-m",
                   "omniswarm_torch.runtime.drone_process", "--device",
                   device]
    t0 = time.perf_counter()
    procs = []
    rows = []
    try:
        for d in range(drones):
            procs.append(subprocess.Popen(
                [*program, "--scenario", str(scenario), "--drone-id",
                 str(d), "--out", str(out_dir / f"out{d}.npz"), "--port",
                 str(port), "--step-wall", str(STEP_WALL)],
                cwd=str(REPO), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        for d, proc in enumerate(procs):
            text, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            row = dict(drone=d, returncode=proc.returncode,
                       tail=text[-1500:], solved=False, estimated=False,
                       relative_ate=None)
            if proc.returncode == 0:
                raw = np.load(out_dir / f"out{d}.npz")
                row.update(loops_found=int(raw["loops_found"]),
                           loops_received=int(raw["loops_received"]),
                           solved=bool(raw["solved"]),
                           cost=float(raw["cost"]),
                           estimated=raw["estimate"].ndim == 3)
                if row["solved"] and "final_poses" in raw:
                    poses = raw["final_poses"]
                    idx = [int(round(t)) for t in raw["kf_times"]]
                    ids = [int(i) for i in raw["window_ids"]]
                    if poses.shape[:2] == (len(idx), len(ids)):
                        row["relative_ate"] = float(
                            metrics.mean_relative_ate(poses,
                                                      data.gt[idx][:, ids]))
            rows.append(row)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return dict(processes=rows, seconds=time.perf_counter() - t0)


# The JAX anchors of the drone-process swarm: the reference's own
# tools/drone_process.py processes on the same scenario, on the CPU
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_process_swarm.py
# --anchor D F, which also reads each drone's final solve's poses), over
# its runs: the drones whose final solve ran in any run, and the worst
# relative ATE (m) of a final solve. At 5 x 100, two runs: every process
# exited 0 and solved, relative ATE 0.0331-0.0460, final costs 99.87-107.81
# (99.47-107.91 over these and four earlier runs, in two of which 2 of 5
# processes died on a keyframe whose landmark datagrams were all lost: see
# swarm/comm.py's _assemble), mostly above acpt_cost 100, so a drone
# writes an estimate in some runs and not in others.
SWARM_ANCHORS = {(5, 100): dict(solved=[0, 1, 2, 3, 4], worst_ate=0.0460)}
SWARM_ATE_BAR = 0.3        # tests/test_multiprocess.py's bar
SWARM_ATE_SLACK = 0.02     # against the JAX run's worst drone
SWARM_PORT = 17971
SWARM_RUNS = 2             # UDP timing differs run to run
SWARM_TIMEOUT_S = 900.0


def swarm_bars(res: dict, anchor: Optional[dict]) -> List[str]:
    """What a run of the swarm fails of its bars: every process exits 0;
    loops were found and received over the swarm; each drone that solved
    has its final solve's relative ATE under ``SWARM_ATE_BAR`` and, with
    an ``anchor``, no worse than its worst drone + ``SWARM_ATE_SLACK``,
    and every drone that solved there solves here. UDP timing decides
    which keyframes meet, so the loops and ATEs are held to bars, not to
    equality."""
    rows = res["processes"]
    bad = [f"drone {r['drone']}: exit {r['returncode']}: {r['tail']}"
           for r in rows if r["returncode"] != 0]
    if not bad:
        if sum(r["loops_found"] for r in rows) <= 0:
            bad.append("no loop found over the swarm")
        if sum(r["loops_received"] for r in rows) <= 0:
            bad.append("no loop received over the swarm")
    bar = SWARM_ATE_BAR
    if anchor is not None:
        bar = min(bar, anchor["worst_ate"] + SWARM_ATE_SLACK)
        bad += [f"drone {d} solved in the JAX run, not here"
                for d in anchor["solved"] if not rows[d]["solved"]]
    bad += [f"drone {r['drone']}: relative ATE {r['relative_ate']} >= {bar}"
            for r in rows if r["solved"] and not (r["relative_ate"] is not None
                                                  and r["relative_ate"] < bar)]
    return bad


def swarm_main(args) -> int:
    """``--swarm D F``: the swarm ``SWARM_RUNS`` times, one JSON line a run
    (with the card's name and power limit and the bars it failed)."""
    from omniswarm_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    name = "cpu"
    if dev.type == "cuda":
        from omniswarm_torch import kernels
        from omniswarm_torch.benchutil import card

        name = card(dev)
        kernels.build()             # once, before the processes start
    anchor = SWARM_ANCHORS.get(tuple(args.swarm))
    failed = 0
    for run in range(SWARM_RUNS):
        res = process_swarm(Path(args.out_dir) / f"run{run}",
                            port=args.port, device=str(dev),
                            drones=args.swarm[0], frames=args.swarm[1],
                            timeout_s=SWARM_TIMEOUT_S)
        bad = swarm_bars(res, anchor)
        for row in res["processes"]:
            if row["returncode"] == 0:
                row.pop("tail")
        failed += bool(bad)
        print(json.dumps(dict(run=run, drones=args.swarm[0],
                              frames=args.swarm[1], card=name, anchor=anchor,
                              failed_bars=bad, **res)), flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.node_entry",
        description="The paced node sessions, or with --swarm the drone "
                    "processes over loopback multicast.")
    ap.add_argument("--swarm", type=int, nargs=2, metavar=("DRONES", "FRAMES"))
    ap.add_argument("--port", type=int, default=SWARM_PORT)
    ap.add_argument("--out-dir", default="build/swarm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.swarm:
        return swarm_main(args)
    res = paced_sessions(device=args.device)
    for name in ("threaded", "inline"):
        res[name].pop("records")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
