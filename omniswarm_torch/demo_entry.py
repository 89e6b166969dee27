"""The system end to end: drones, loop detection, the lossy bus, PCM and the
sliding-window solves, from pixels (or features) to poses.

Two entry points, counterparts of the repository's two examples; each runs
every drone as a ``DroneNode`` (front-end keyframes, the LoopDetector, the
LoopNet over one ``LossyBus``, PCM and the estimator) and returns the
metrics of ``examples/run_image_demo.py``'s artifact (recall and precision
before and after PCM, per-drone cost and relative / absolute ATE, views/s
and the median keyframe latency):

- ``feature_demo_entry``: ``examples/run_demo.py`` (:37-80), 3 drones x 30
  frames over the feature-level ``VisualWorld(seed=7, n_landmarks=800,
  extent=8.0)``, a keyframe every 2nd frame, ``LossyBus(drop_rate=0.05,
  seed=3)``; with ``report_dir``, each solved drone's accuracy report
  (``eval.report.write_report``: ``summary.json``, and the figures where
  matplotlib is installed) under ``report_dir/drone<d>/``, as the example
  writes it (:80-91).
- ``image_demo_entry``: ``examples/run_image_demo.py`` (:76-311) at its
  artifact's size, 5 drones x 30 frames, a keyframe every 2nd frame: 75
  keyframes of 4-direction stereo at 400 x 208 rendered in the textured
  room (``frontend_entry.prepare``, which renders in the demo's order),
  extracted by ``OmniLoopCam`` one step (40 views) at a time, with the
  demo's ``FrontendParams`` (512-keyframe databases, 8 candidates per DB,
  6 loops per query, the geometric override at 25 inliers, 256 PnP
  hypotheses, yaw gated modulo pi/2) and ``acpt_cost`` 150.

Keyframe latency is the demo's: the step's extraction time over the drones
plus the host time of one ``on_local_keyframe`` (the detector's tick), from
the third keyframe step on. The metrics add the detectors' median tick
(host ms around a synchronised ``on_keyframes_batch``) and their verify
lanes per tick. The sessions and the
scoring take a ``Kit`` of the package's classes and helpers (nodes, bus,
parameters, simulator, metrics, loop keys), so ``tools/demo_anchors.py``
drives and scores the JAX package with its own.

    python -m omniswarm_torch.demo_entry            # on the GPU
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import Counter
from types import ModuleType
from typing import Callable, NamedTuple

import numpy as np

FEATURE_DRONES = 3
IMAGE_DRONES = 5
FRAMES = 30
KF_EVERY = 2             # a keyframe every 2nd frame (both demos)
DROP = 0.05              # the bus's drop rate
FEATURE_FP = dict(max_db_size=1024, min_loop_matches=12, match_index_dist=5,
                  netvlad_thres=0.5, pnp_iterations=128)
IMAGE_FP = dict(max_db_size=512, min_loop_matches=17, match_index_dist=4,
                netvlad_thres=0.35, min_loop_matches_init=12,
                search_nearest_num=8, max_loops_per_query=6,
                balanced_db_candidates=True, geometric_override_matches=25,
                pnp_iterations=256, accept_loop_yaw_mod=float(np.pi / 2))
SOLVER = dict(pcm_redundant=False, max_iterations=60, init_z_movement=0.05)
REVISIT_M = 1.5          # ground-truth distance of a revisit opportunity
TRUE_POS_M = 0.30        # a loop is true within 0.30 m and 0.20 rad of GT
TRUE_YAW = 0.20


def image_acpt_cost(num_drones: int) -> float:
    """The demo's max_accept_cost: 150, scaled with the range pairs past
    D=5 (run_image_demo.py:104-109)."""
    return 150.0 * max(1.0, (num_drones * (num_drones - 1) / 2) / 10.0)


class Kit(NamedTuple):
    """One package's classes and helpers that the sessions and the scoring
    call: the port's (``port_kit``) or the JAX package's
    (``tools/demo_anchors.py``), so that each side is driven, simulated
    and scored by its own code."""
    DroneNode: type
    LossyBus: type
    FrontendParams: type
    SolverParams: type
    VisualWorld: type
    OmniLoopCam: type
    sim: ModuleType              # generate, SimParams
    metrics: ModuleType          # ate_pos, align_yaw_translation,
    #                              mean_relative_ate
    loop_key: Callable
    delta_pose_np: Callable
    wrap: Callable
    device_kw: dict              # extra keywords of DroneNode / OmniLoopCam


def port_kit(dev) -> Kit:
    from omniswarm_torch import sim
    from omniswarm_torch.config import FrontendParams, SolverParams
    from omniswarm_torch.eval import metrics
    from omniswarm_torch.sim.simulator import delta_pose_np, wrap
    from omniswarm_torch.sim.visual_world import VisualWorld
    from omniswarm_torch.swarm.comm import LossyBus
    from omniswarm_torch.swarm.estimator import loop_key
    from omniswarm_torch.swarm.loop_cam import OmniLoopCam
    from omniswarm_torch.swarm.node import DroneNode

    return Kit(DroneNode, LossyBus, FrontendParams, SolverParams, VisualWorld,
               OmniLoopCam, sim, metrics, loop_key, delta_pose_np, wrap,
               dict(device=dev))


def drive_session(nodes, bus, data, kf_every: int,
                  make_keyframes: Callable,
                  around_frame: Callable = None) -> dict:
    """Feed every frame to every node (the demos' loop): UWB/VIO frames,
    the keyframe step's keyframes (``make_keyframes(step, k, t)`` returns
    (per-drone keyframes, extraction seconds)), the bus, the comm scans.
    Each frame k runs inside ``around_frame(k)`` when given (a tracer's
    hook).
    """
    D = len(nodes)
    n_kf, kf_steps, fe_time, fe_views, lat_ms = 0, [], 0.0, 0, []
    for k in range(data.gt.shape[0]):
        with (around_frame(k) if around_frame else contextlib.nullcontext()):
            t = float(data.times[k])
            vio = {d: data.vio[k, d] for d in range(D)}
            ranges = {(a, b): float(data.ranges[k, a, b])
                      for a in range(D) for b in range(D)
                      if a != b and data.range_valid[k, a, b]}
            for node in nodes:
                node.on_swarm_frame(t, vio, ranges)
            if k % kf_every == 0:
                kfs, t_extract = make_keyframes(len(kf_steps), k, t)
                kf_steps.append(k)
                steady = n_kf >= 2 * D
                if steady:
                    fe_time += t_extract
                    fe_views += 4 * D
                for d, node in enumerate(nodes):
                    t0 = time.perf_counter()
                    node.on_local_keyframe(kfs[d], t)
                    if steady:
                        lat_ms.append((t_extract / D + time.perf_counter()
                                       - t0) * 1e3)
                    n_kf += 1
            bus.step(t + 0.01)
            for node in nodes:
                node.step(t + 0.02)
    return dict(n_kf=n_kf, kf_steps=kf_steps, fe_time=fe_time,
                fe_views=fe_views, kf_lat_ms=lat_ms)


def _loop_error(kit: Kit, lp, gt):
    ka, kb = int(round(lp.t_a)), int(round(lp.t_b))
    gt_dp = kit.delta_pose_np(gt[ka, lp.drone_a], gt[kb, lp.drone_b])
    err_p = float(np.linalg.norm(np.asarray(lp.dpose)[:3] - gt_dp[:3]))
    err_y = abs(kit.wrap(float(lp.dpose[3]) - gt_dp[3]))
    return err_p, err_y


def score(kit: Kit, nodes, data, session: dict, guard: int,
          report: Callable = None) -> dict:
    """Solve every node once and score the run as the image demo does:
    loop precision by ground truth, recall over the revisit opportunities
    (ground-truth positions within 1.5 m; same-drone pairs at least
    ``guard`` frames apart), precision of the loops that survive PCM, and
    each drone's cost and relative / absolute ATE against ground truth.
    ``report(drone, estimate, gt, frames, vio)`` is called for each solved
    drone (the example's report)."""
    metrics = kit.metrics
    gt = data.gt
    uniq = {}
    for node in nodes:
        for lp in node.estimator.loops:
            uniq[kit.loop_key(lp)] = lp
    true_keys = set()
    for key, lp in uniq.items():
        err_p, err_y = _loop_error(kit, lp, gt)
        if err_p < TRUE_POS_M and err_y < TRUE_YAW:
            true_keys.add(key)
    found = set()
    for lp in uniq.values():
        a = (lp.drone_a, int(round(lp.t_a)))
        b = (lp.drone_b, int(round(lp.t_b)))
        found.add((min(a, b), max(a, b)))
    steps = session["kf_steps"]
    D = len(nodes)
    opps = set()
    for i, ka in enumerate(steps):
        for kb in steps[:i + 1]:
            for da in range(D):
                for db in range(D):
                    if (da == db and abs(ka - kb) < guard) or \
                            (da, ka) == (db, kb):
                        continue
                    if np.linalg.norm(gt[ka, da, :3]
                                      - gt[kb, db, :3]) < REVISIT_M:
                        a, b = (da, ka), (db, kb)
                        opps.add((min(a, b), max(a, b)))
    missed = opps - found
    missed_same = sum(1 for a, b in missed if a[0] == b[0])

    per_drone, estimates, all_solved = [], [], True
    t_end = float(data.times[-1])
    for node in nodes:
        out = node.solve(t=t_end)
        est = node.estimator
        if not out.get("solved") or est.estimate is None:
            all_solved = False
            per_drone.append(dict(drone=int(node.drone_id), solved=False))
            estimates.append(None)
            continue
        idx = [int(round(kf.t)) for kf in est.window]
        g, v = gt[idx], data.vio[idx]
        ates = [metrics.ate_pos(metrics.align_yaw_translation(
            est.estimate[:, di], g[:, di])[:, :3], g[:, di, :3])
            for di in range(est.estimate.shape[1])]
        per_drone.append(dict(
            drone=int(node.drone_id), solved=True, cost=float(out["cost"]),
            relative_ate_cm=float(metrics.mean_relative_ate(est.estimate, g)
                                  * 100),
            vio_relative_ate_cm=float(metrics.mean_relative_ate(v, g) * 100),
            mean_abs_ate_cm=float(np.mean(ates) * 100)))
        estimates.append(np.array(est.estimate))
        if report is not None:
            report(int(node.drone_id), est.estimate, g, idx, v)

    inlier_keys = set()
    for node in nodes:
        for keys in list(node.estimator.pair_inliers.values()) + list(
                node.estimator.external_inliers.values()):
            inlier_keys.update(tuple(k) for k in keys)
    kept = [key for key in uniq if key in inlier_keys]
    pcm_true = sum(1 for key in kept if key in true_keys)
    n_true = len(true_keys)
    n_false = len(uniq) - n_true
    lat = session["kf_lat_ms"]
    ticks = [tk for node in nodes
             for tk in getattr(node.detector, "ticks", ())]
    return {
        "drones": D, "frames": int(gt.shape[0]), "keyframes": session["n_kf"],
        "frontend_views_per_s": (session["fe_views"] / session["fe_time"]
                                 if session["fe_time"] > 0 else None),
        "keyframe_latency_ms": float(np.median(lat)) if lat else None,
        "loops_unique": len(uniq), "loops_true": n_true,
        "loops_false": n_false,
        "loop_precision": n_true / max(len(uniq), 1),
        "loop_precision_post_pcm": pcm_true / max(len(kept), 1),
        "loops_false_post_pcm": len(kept) - pcm_true,
        "loop_recall": len(opps & found) / max(len(opps), 1),
        "revisit_opportunities": len(opps),
        "missed_same_drone": missed_same,
        "missed_cross_drone": len(missed) - missed_same,
        "all_solved": all_solved, "per_drone": per_drone,
        "loops_found": sum(n.loops_found for n in nodes),
        "loops_received": sum(n.loops_received for n in nodes),
        "loop_keys": sorted([list(k) for k in uniq]),
        "false_keys": sorted([list(k) for k in uniq
                              if k not in true_keys]),
        "detector_ticks": len(ticks),
        "detector_tick_ms_median": (float(np.median([ms for _, ms in ticks]))
                                    if ticks else None),
        "verify_lanes_per_tick": {int(k): v for k, v in sorted(
            Counter(lanes for lanes, _ in ticks).items())},
        "estimates": estimates,
    }


def run_feature_demo(kit: Kit, report: Callable = None) -> dict:
    """``examples/run_demo.py``'s session with the given package's kit;
    returns ``score``'s metrics (``report``: see ``score``)."""
    D = FEATURE_DRONES
    data = kit.sim.generate(kit.sim.SimParams(
        num_drones=D, num_frames=FRAMES, seed=7, radius_range=(2.0, 4.0),
        z_range=(0.8, 2.0)))
    world = kit.VisualWorld(seed=7, n_landmarks=800, extent=8.0)
    bus = kit.LossyBus(drop_rate=DROP, seed=3)
    nodes = [kit.DroneNode(d, bus, solver_params=kit.SolverParams(**SOLVER),
                           frontend_params=kit.FrontendParams(**FEATURE_FP),
                           global_dim=world.global_dim, seed=d,
                           **kit.device_kw)
             for d in range(D)]

    def make_keyframes(_step, k, t):
        return [world.make_keyframe(d, k, data.gt[k, d], t,
                                    vio_pose=data.vio[k, d])
                for d in range(D)], 0.0

    session = drive_session(nodes, bus, data, KF_EVERY, make_keyframes)
    return score(kit, nodes, data, session,
                 guard=FEATURE_FP["match_index_dist"] * KF_EVERY,
                 report=report)


def run_image_demo(kit: Kit, prep, around_frame: Callable = None) -> dict:
    """``examples/run_image_demo.py``'s session on pre-rendered steps
    (``frontend_entry.prepare``, or the JAX package's rendering in the
    same order) with the given package's kit. The drones and the keyframe
    stride are the rendering's."""
    from omniswarm_torch.frontend_entry import BASELINE

    D = prep.data.gt.shape[1]
    fp = kit.FrontendParams(**IMAGE_FP)
    bus = kit.LossyBus(drop_rate=DROP, seed=3)
    nodes = [kit.DroneNode(d, bus, solver_params=kit.SolverParams(
        **SOLVER, acpt_cost=image_acpt_cost(D)), frontend_params=fp,
        global_dim=4096, seed=d, **kit.device_kw) for d in range(D)]
    cam = kit.OmniLoopCam(params=fp, intrinsics=prep.intr, baseline=BASELINE,
                          **kit.device_kw)

    def make_keyframes(step, _k, _t):
        t0 = time.perf_counter()
        kfs = cam.on_fisheye_frames_batch(prep.steps[step])
        return kfs, time.perf_counter() - t0

    session = drive_session(nodes, bus, prep.data, prep.kf_every,
                            make_keyframes, around_frame)
    out = score(kit, nodes, prep.data, session,
                guard=IMAGE_FP["match_index_dist"] * prep.kf_every)
    out["render_s"] = prep.render_s
    return out


def feature_demo_entry(device="cuda", report_dir=None) -> dict:
    """``examples/run_demo.py`` on the port (see the module docstring);
    with ``report_dir``, each solved drone's report directory is in its
    ``per_drone`` entry as ``report``."""
    import os

    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.eval.report import write_report

    dirs = {}

    def report(drone, estimate, gt, frames, vio):
        dirs[drone] = os.path.join(str(report_dir), f"drone{drone}")
        write_report(dirs[drone], estimate, gt,
                     times=np.asarray(frames, float), vio=vio)

    res = run_feature_demo(port_kit(resolve_device(device)),
                           report if report_dir is not None else None)
    for d in res["per_drone"]:
        if d["drone"] in dirs:
            d["report"] = dirs[d["drone"]]
    return res


def image_demo_entry(device="cuda", prep=None, around_frame=None) -> dict:
    """``examples/run_image_demo.py`` on the port (see the module
    docstring). ``prep``: the demo's rendered steps,
    ``frontend_entry.prepare()`` (rendered here if None);
    ``around_frame(k)``: a context manager around frame k (a tracer's
    hook). Adds K2's launches to the metrics."""
    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.frontend_entry import prepare
    from omniswarm_torch.ops.frontend_kernels import grid_nms

    dev = resolve_device(device)
    if prep is None:
        prep = prepare(IMAGE_DRONES, FRAMES, KF_EVERY)
    k2_0 = grid_nms.launches
    out = run_image_demo(port_kit(dev), prep, around_frame)
    out["k2_launches"] = grid_nms.launches - k2_0
    out["keyframe_steps"] = len(prep.steps)
    return out


def summary(res: dict) -> dict:
    """A run's metrics without its estimates, for one JSON line."""
    return {k: v for k, v in res.items() if k != "estimates"}


if __name__ == "__main__":
    print(json.dumps(summary(feature_demo_entry())))
    print(json.dumps(summary(image_demo_entry())))
