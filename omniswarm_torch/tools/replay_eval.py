"""Flight-log replay through the online estimator, with the accuracy
report (the reference's bag-replay evaluation).

    python -m omniswarm_torch.tools.replay_eval --logs a.csv:530 b.csv:20
        [--frames 40] [--dt 0.5] [--solve-every 10] [--init-xy 0.3]
        [--init-z 0.02] [--kf-movement 0.2] [--loops]
        [--out build/replay_out] [--device cuda|cpu]

Counterpart of ``tools/replay_eval.py``: CSV flight logs (one
``path:t_offset`` per drone) become a dataset through
``io.flightlog.replay_dataset`` (``--loops``: loop closures synthesized
over the real trajectories), which feeds ``swarm.SwarmEstimator`` at
keyframe rate (every ``--dt`` seconds; a solve every ``--solve-every``
frames and at the end; the PC-replay gates ``--init-xy``, ``--init-z``,
``--kf-movement``), and ``eval.report.write_report`` writes
``summary.json`` (and figures where matplotlib is installed) for the final
window against the logs' ground truth into ``--out``. The estimator solves
on ``--device``. ``write_sim_logs`` writes logs in the reference's CSV
layout from the port's simulator, for runs without recorded flights.
"""
from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from omniswarm_torch import sim
from omniswarm_torch.benchutil import refuse_reference_output
from omniswarm_torch.config import SolverParams
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.eval import metrics
from omniswarm_torch.eval.report import write_report
from omniswarm_torch.io.flightlog import replay_dataset
from omniswarm_torch.swarm.estimator import LoopRecord, SwarmEstimator

REFERENCE_OUTPUTS = ("replay_out", "REPLAY_EVAL.json")


def write_sim_logs(directory: str, drones: int = 3, seconds: float = 60.0,
                   rate: float = 50.0, seed: int = 0) -> List[str]:
    """One CSV flight log a drone in the reference's column layout (``ts,
    ctrl_mode, pos(3), vel(3), rpy(3), pos_sp(3), vel_sp(3), acc_sp(3),
    rpy_sp(3), thr_sp``) at ``rate`` Hz from the ground truth of
    ``sim.generate`` (seed ``seed``): the position and yaw of each drone,
    its velocity by finite differences, zero roll, pitch and set-points.
    Returns the paths."""
    n = int(round(seconds * rate))
    data = sim.generate(sim.SimParams(num_drones=drones, num_frames=n,
                                      dt=1.0 / rate, seed=seed))
    os.makedirs(directory, exist_ok=True)
    ts = 100.0 + data.times
    paths = []
    for d in range(drones):
        pos = data.gt[:, d, :3]
        rpy = np.zeros((n, 3))
        rpy[:, 2] = data.gt[:, d, 3]
        cols = [ts[:, None], np.full((n, 1), 2.0), pos,
                np.gradient(pos, axis=0) * rate, rpy, np.zeros((n, 12)),
                np.full((n, 1), 0.5)]
        path = os.path.join(directory, f"flight{d}.csv")
        np.savetxt(path, np.concatenate(cols, 1), delimiter=",",
                   fmt="%.9f")
        paths.append(path)
    return paths


def replay(logs, *, frames: int = 40, dt: float = 0.5,
           out: str = "build/replay_out", solve_every: int = 10,
           init_xy: float = 0.3, init_z: float = 0.02,
           kf_movement: float = 0.2, loops: bool = False,
           device="cuda") -> dict:
    """The replay (see the module docstring); ``logs`` a list of (path,
    t_offset). Returns ``solves`` (each solve's status, the last the final
    one), ``summary`` (the report's, None when the final solve failed),
    ``relative_ate`` and ``vio_relative_ate`` over the final window."""
    data = replay_dataset(logs, num_frames=frames, dt=dt, synth_loops=loops)
    D = data.gt.shape[1]
    est = SwarmEstimator(SolverParams(self_id=0, pcm_redundant=True,
                                      init_xy_movement=init_xy,
                                      init_z_movement=init_z,
                                      kf_movement=kf_movement),
                         device=device)
    loops_by_frame = {}
    for lp in data.loops:
        loops_by_frame.setdefault(lp.frame_a, []).append(lp)
    solves = []
    for k in range(frames):
        vio = {d: data.vio[k, d] for d in range(D)}
        ranges = {(a, b): float(data.ranges[k, a, b])
                  for a in range(D) for b in range(D)
                  if a != b and data.range_valid[k, a, b]}
        est.on_swarm_frame(float(data.times[k]), vio, ranges)
        for lp in loops_by_frame.get(k, ()):
            est.on_loop(LoopRecord(
                t_a=float(data.times[lp.frame_a]), drone_a=lp.drone_a,
                t_b=float(data.times[lp.frame_b]), drone_b=lp.drone_b,
                dpose=lp.dpose, pos_std=lp.pos_std, yaw_std=lp.yaw_std))
        if (k + 1) % solve_every == 0:
            solves.append(est.solve())
            print(f"t={data.times[k]:6.1f}s solve: {solves[-1]}",
                  flush=True)
    solves.append(est.solve())
    result = dict(solves=solves, summary=None, relative_ate=None,
                  vio_relative_ate=None)
    if not solves[-1].get("solved") or est.estimate is None:
        print(f"final solve failed: {solves[-1]}", flush=True)
        return result
    kf_idx = [int(round(kf.t / dt)) for kf in est.window]
    gt = data.gt[kf_idx]
    result.update(
        relative_ate=metrics.mean_relative_ate(est.estimate, gt),
        vio_relative_ate=metrics.mean_relative_ate(data.vio[kf_idx], gt),
        summary=write_report(out, est.estimate, gt,
                             times=np.asarray(kf_idx, float) * dt,
                             vio=data.vio[kf_idx]))
    print(f"relative ATE {result['relative_ate'] * 100:.1f} cm "
          f"(raw VIO {result['vio_relative_ate'] * 100:.1f} cm)"
          f" → {out}/summary.json", flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.replay_eval",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--logs", nargs="+", required=True,
                    help="path:toffset per drone")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--dt", type=float, default=0.5)
    ap.add_argument("--out", default="build/replay_out")
    ap.add_argument("--solve-every", type=int, default=10)
    ap.add_argument("--init-xy", type=float, default=0.3)
    ap.add_argument("--init-z", type=float, default=0.02)
    ap.add_argument("--kf-movement", type=float, default=0.2,
                    help="keyframe admission threshold (small for slow "
                         "real circle flights)")
    ap.add_argument("--loops", action="store_true",
                    help="synthesize loop closures over the real "
                         "trajectories (simulator-tier place recognition)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    dev = resolve_device(args.device)
    logs = []
    for spec in args.logs:
        path, _, off = spec.rpartition(":")
        logs.append((path, float(off)))
    with torch.no_grad():
        return replay(logs, frames=args.frames, dt=args.dt, out=args.out,
                      solve_every=args.solve_every, init_xy=args.init_xy,
                      init_z=args.init_z, kf_movement=args.kf_movement,
                      loops=args.loops, device=dev)


if __name__ == "__main__":
    main()
