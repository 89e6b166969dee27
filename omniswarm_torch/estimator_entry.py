"""The estimator slice end to end: one scripted serving session.

A ``SwarmEstimator`` is fed a simulated 5-drone flight frame by frame and
solves every 10th frame, as a deployed node would (the window fills to 100
keyframes, then evicts at random):

- ``sim.generate(SimParams(num_drones=5, num_frames=150, seed=0,
  loop_outlier_rate=0.2, loop_outlier_mag=4.0))``;
- the solver section of ``configs/swarm5.yaml`` as ``SolverParams``
  (``max_frame_number=100``, ``max_iterations=60``, ``pcm_redundant=False``,
  ``self_id=0``, the rest defaults) with ``max_solver_time=0`` (iteration
  counts independent of the card's speed) and ``acpt_cost`` as given;
- each frame through ``on_swarm_frame``, each loop once both of its frames
  have arrived (``on_loop``), each detection at its frame (``on_detection``);
- ``prepare_solve`` / ``execute_solve`` / ``finalize_solve`` after every
  10th frame (15 solves);
- ``predict_swarm_relative(t)`` at every frame once a solve was accepted.

Two cuts from the deployment, both to keep the reference's CPU run of the
same session short: a solve every 10th keyframe, not at ``force_freq`` (1
Hz); and callers holding the session to the reference's anchors pass
``acpt_cost=1000`` (every solve after the first stays warm), not the
shipped 100.

``drive_session`` takes the estimator and its record classes as arguments,
so ``tools/estimator_anchors.py`` drives the reference's estimator through
the same code.

    python -m omniswarm_torch.estimator_entry            # on the GPU
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Callable, ContextManager, Optional

import numpy as np

SESSION = dict(num_drones=5, num_frames=150, seed=0, loop_outlier_rate=0.2,
               loop_outlier_mag=4.0)
SOLVE_EVERY = 10
SOLVER_SECTION = dict(max_frame_number=100, max_iterations=60,
                      pcm_redundant=False, self_id=0)


def session_params(params_cls, acpt_cost: float):
    """The session's ``SolverParams`` (of either package)."""
    return params_cls(**SOLVER_SECTION, max_solver_time=0.0,
                      acpt_cost=float(acpt_cost))


def inlier_digest(keys) -> str:
    """Short hash of a PCM inlier set of loop keys (order-free)."""
    text = json.dumps(sorted([int(v) for v in k] for k in keys))
    return hashlib.sha1(text.encode()).hexdigest()[:12]


def frame_runs(frames) -> list:
    """Ascending frame indices as [first, last] runs of consecutive ones."""
    runs = []
    for f in frames:
        if runs and runs[-1][1] == f - 1:
            runs[-1][1] = f
        else:
            runs.append([f, f])
    return runs


def linear_path(prep: dict) -> dict:
    """The linear path a prepared solve takes: the lock-step batch (always
    Woodbury) for a multi-init, else ``linear="auto"``'s choice (PCG once
    4 x loop capacity > 4096 or F > 4096), and the cyclic reduction's
    packing."""
    from omniswarm_torch.solver.dense import _auto_pack, uses_pcg

    graph = prep["dense_graph"]
    if graph is None:
        return dict(linear="generic", pack=None, lanes=None if
                    prep["inits"] is None else int(prep["inits"].shape[0]))
    F, D = np.shape(graph.pose_valid)
    Lb = np.shape(graph.loops.valid)[0]
    lanes = None
    if prep["multi_init"]:
        linear, lanes = "smw", int(prep["inits"].shape[0])
    else:
        linear = "pcg" if uses_pcg("auto", False, F, Lb) else "smw"
    return dict(linear=linear, pack=_auto_pack(F, 4 * D), lanes=lanes,
                loop_capacity=int(Lb))


def window_frames(est, times: np.ndarray, rows: Optional[int] = None):
    """Sim frame index of each window keyframe (the first ``rows``)."""
    kfs = est.window if rows is None else est.window[:rows]
    return [int(np.searchsorted(times, kf.t)) for kf in kfs]


def relative_ate(poses: np.ndarray, frames, gt: np.ndarray) -> float:
    """Mean relative ATE of window poses against the ground truth."""
    from omniswarm_torch.eval.metrics import mean_relative_ate

    return mean_relative_ate(np.asarray(poses)[:len(frames)], gt[frames])


def drive_session(est, data, loop_cls, det_cls, telemetry, *,
                  solve_every: int = SOLVE_EVERY,
                  launches: Optional[Callable[[], int]] = None,
                  around_solve: Optional[Callable[[int], ContextManager]]
                  = None) -> dict:
    """Feed ``data`` into ``est`` frame by frame, solving every
    ``solve_every``-th frame; returns one record per solve, the predictions'
    summary and the final state. ``launches`` reads a kernel launch count
    (K1's, on the port); ``around_solve(i)`` is entered around solve i (a
    profiler, in ``profile_solve.py``)."""
    D = data.gt.shape[1]
    loops_at = {}
    for lp in data.loops:
        loops_at.setdefault(max(lp.frame_a, lp.frame_b), []).append(lp)
    dets_at = {}
    for det in data.detections:
        dets_at.setdefault(det.frame, []).append(det)
    solves, pred_us, pred_finite, self_origin = [], [], True, 0.0
    for k in range(data.gt.shape[0]):
        t = float(data.times[k])
        ranges = {(a, b): float(data.ranges[k, a, b])
                  for a in range(D) for b in range(D)
                  if a != b and data.range_valid[k, a, b]}
        est.on_swarm_frame(t, {d: data.vio[k, d] for d in range(D)}, ranges)
        for lp in loops_at.get(k, ()):
            est.on_loop(loop_cls(
                t_a=float(data.times[lp.frame_a]), drone_a=lp.drone_a,
                t_b=float(data.times[lp.frame_b]), drone_b=lp.drone_b,
                dpose=lp.dpose, pos_std=lp.pos_std, yaw_std=lp.yaw_std))
        for det in dets_at.get(k, ()):
            est.on_detection(det_cls(
                t=t, drone_a=det.drone_a, drone_b=det.drone_b,
                direction=det.direction, inv_dep=det.inv_dep))
        if (k + 1) % solve_every == 0:
            around = around_solve or (lambda i: contextlib.nullcontext())
            with around(len(solves)):
                solves.append(_solve(est, data, telemetry, launches))
        if est.estimate is not None:
            t0 = time.perf_counter()
            pred = est.predict_swarm_relative(t)
            pred_us.append((time.perf_counter() - t0) * 1e6)
            pred_finite &= len(pred) == D and all(
                bool(np.isfinite(p).all()) for p in pred.values())
            self_origin = max(self_origin, float(np.abs(
                pred.get(est.self_id, np.full(4, np.inf))).max()))
    frames = window_frames(est, data.times, len(est.estimate)
                           if est.estimate is not None else 0)
    return dict(
        solves=solves, iter_ms_ema=est._iter_ms_ema,
        predictions=dict(count=len(pred_us), finite=bool(pred_finite),
                         self_max_abs=self_origin,
                         us_median=float(np.median(pred_us))
                         if pred_us else None),
        final=dict(
            frames=frames,
            relative_ate=relative_ate(est.estimate, frames, data.gt)
            if est.estimate is not None else None,
            cov_diag={int(d): np.diag(c).astype(float).tolist()
                      for d, c in sorted(est.latest_covariances.items())}),
        estimate=None if est.estimate is None else np.array(est.estimate))


def _solve(est, data, telemetry, launches) -> dict:
    frames = window_frames(est, data.times)
    k1 = launches() if launches else 0
    prep = est.prepare_solve()
    if prep.get("refused"):
        return dict(frames=frames, refused=prep["status"]["reason"])
    path = linear_path(prep)
    res = est.execute_solve(prep)
    out = est.finalize_solve(prep, res)
    poses = est._last_padded_poses
    return dict(
        frames=frames, multi_init=prep["multi_init"],
        finish_init=out["finish_init"], cost=out["cost"],
        iterations=out["iterations"], F=out["num_frames"],
        D=out["num_drones"], **path,
        result_ate=relative_ate(poses, frames, data.gt),
        inliers={f"{a}-{b}": [len(s), inlier_digest(s)]
                 for (a, b), s in sorted(est.pair_inliers.items())},
        host_ms=telemetry.timer("estimator.solve.host_build").last_ms,
        device_ms=telemetry.timer("estimator.solve.device").last_ms,
        k1_launches=(launches() - k1) if launches else 0,
        cost_over_acpt=out["cost"] / est.params.acpt_cost)


def estimator_entry(device="cuda", acpt_cost: float = 1000.0, *,
                    rng_seed: int = 0, around_solve=None) -> dict:
    """Run the session on ``device`` (see the module docstring); returns
    ``drive_session``'s record."""
    from omniswarm_torch import sim
    from omniswarm_torch.config import SolverParams
    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.solver.fused_level import fused_reduction_level
    from omniswarm_torch.swarm import DetRecord, LoopRecord, SwarmEstimator
    from omniswarm_torch.utils.telemetry import GLOBAL

    dev = resolve_device(device)
    data = sim.generate(sim.SimParams(**SESSION))
    est = SwarmEstimator(session_params(SolverParams, acpt_cost),
                         rng_seed=rng_seed, device=dev)
    return drive_session(est, data, LoopRecord, DetRecord, GLOBAL,
                         launches=lambda: fused_reduction_level.launches,
                         around_solve=around_solve)


if __name__ == "__main__":
    out = estimator_entry()
    out.pop("estimate")
    print(json.dumps(out))
