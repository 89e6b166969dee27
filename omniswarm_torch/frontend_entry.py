"""The visual front-end end to end: pixels to keyframes and place retrieval.

Counterpart of the keyframe half of ``examples/run_image_demo.py``:

1. simulate 5 drones x 30 steps (seed 7, radii 2-3.5 m, heights 0.8-2 m);
2. render, every ``kf_every``-th step, each drone's 4-direction stereo rig
   in a textured ``RoomWorld`` (half 6 m, seed 11) as uint8 images, all
   before the timed window (rendering is host numpy);
3. extract each step's 5 keyframes in one ``OmniLoopCam`` batch: 40 images
   through SuperPoint (NMS by K2), the 20 lefts through NetVLAD, mutual
   matching, stereo triangulation;
4. query the step's keyframes against a PlaceDB of every earlier keyframe
   (one K3 launch; capacity ``max_db_size`` = 4096, recency guard 4
   frames; batch members do not see each other), then add them;
5. score: keypoints and landmarks per keyframe, top-1 retrieval precision
   (of the queries whose best similarity reaches ``netvlad_thres`` = 0.35,
   the share whose hit is a revisit by the demo's gate: ground-truth
   positions within 1.5 m and, for the same drone, at least 8 frames
   apart), extraction ms per step (host clock around a synchronised step)
   and K2/K3 launches.

``keyframe_checksums`` and ``checksum_faults`` hold a run's keyframes
against another run's (the JAX package's, in ``chip_smoke.py``) without
storing their arrays.

    python -m omniswarm_torch.frontend_entry          # on the GPU
"""
from __future__ import annotations

import json
import time
from typing import List, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from omniswarm_torch import sim
from omniswarm_torch.config import FrontendParams
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.ops import placedb
from omniswarm_torch.ops.frontend_kernels import grid_nms, retrieval_top1
from omniswarm_torch.sim.image_world import RoomWorld, _rotz
from omniswarm_torch.sim.simulator import wrap
from omniswarm_torch.swarm.comm import KeyframeData
from omniswarm_torch.swarm.loop_cam import CameraIntrinsics, OmniLoopCam

BASELINE = 0.2          # stereo baseline of the demo's rig (m)
REVISIT_M = 1.5         # ground-truth distance of a true revisit (m)
STEADY_STEP = 2         # steps before this one warm up (as the demo)


class FrontendResult(NamedTuple):
    keyframes: List[KeyframeData]   # step-major, drone-minor
    keypoints: np.ndarray           # (n_kf,) valid SuperPoint keypoints
    landmarks: np.ndarray           # (n_kf,) triangulated landmarks
    top1_idx: np.ndarray            # (n_kf,) DB slot of the best hit
    top1_sim: np.ndarray            # (n_kf,) its similarity (-inf: none)
    precision: float                # top-1 retrieval precision
    confident: int                  # queries with sim >= netvlad_thres
    step_ms: np.ndarray             # (steps,) extraction wall ms per step
    views_per_s: float              # stereo views per s, steps >= 2
    k2_launches: int
    k3_launches: int
    render_s: float                 # host seconds spent rendering


def render_direction_stereo(world, pose, view_yaw, intr, h, w, rng):
    """(left, right) uint8 views of one rig direction (run_image_demo.py)."""
    cam_pose = np.asarray(pose, float).copy()
    cam_pose[3] = wrap(cam_pose[3] + view_yaw)
    left = world.render(cam_pose, intr, h, w, rng=rng)
    off_w = _rotz(cam_pose[3]) @ np.array([0.0, -BASELINE, 0.0])
    pose_r = cam_pose.copy()
    pose_r[:3] += off_w
    right = world.render(pose_r, intr, h, w, rng=rng)
    to_u8 = lambda im: (np.clip(im, 0.0, 1.0) * 255.0).astype(np.uint8)
    return to_u8(left), to_u8(right)


def render_steps(data, fp: FrontendParams, intr, kf_every: int):
    """Every keyframe step's entries, in the demo's rendering order."""
    world = RoomWorld(half=6.0, seed=11)
    rng = np.random.default_rng(0)
    steps = []
    D = data.gt.shape[1]
    for k in range(0, data.gt.shape[0], kf_every):
        t = float(data.times[k])
        entries = []
        for d in range(D):
            pairs = [render_direction_stereo(world, data.gt[k, d], vy, intr,
                                             fp.height, fp.width, rng)
                     for vy in OmniLoopCam.VIEW_YAWS]
            entries.append((d, k, t, data.vio[k, d], pairs))
        steps.append(entries)
    return steps


def top1_precision(gt: np.ndarray, keyframes, top1_idx, top1_sim,
                   thres: float, guard: int):
    """(precision, confident): of the queries with sim >= thres, the share
    whose hit is a revisit by the demo's gate (run_image_demo.py:197-211):
    ground-truth positions within REVISIT_M, and for the same drone at
    least ``guard`` frames apart. DB slots are insertion order, i.e.
    keyframe order (capacity >= keyframes)."""
    confident = true = 0
    for kf, j, s in zip(keyframes, top1_idx, top1_sim):
        if not s >= thres:
            continue
        hit = keyframes[int(j)]
        confident += 1
        if (hit.drone_id == kf.drone_id
                and abs(hit.frame_id - kf.frame_id) < guard):
            continue
        dist = np.linalg.norm(gt[kf.frame_id, kf.drone_id, :3]
                              - gt[hit.frame_id, hit.drone_id, :3])
        true += int(dist < REVISIT_M)
    return true / max(confident, 1), confident


# Tolerances of checksum_faults. A keypoint that flips at the detection
# threshold or the top-K cut replaces one keypoint and at most one landmark
# of its keyframe; a fault of layout or arithmetic moves every keyframe. So
# each keyframe may differ by about two flips, and the median keyframe must
# agree closely.
LANDMARK_COUNT_RTOL = 0.01      # per keyframe, and at least 2 landmarks
LANDMARK_MAX_INV = 1 / 0.3      # 1/m: LoopCam keeps depths above 0.3 m
KP_MEDIAN_PX = 1.0
LM_MEDIAN_INV = 1e-2            # 1/m
GD_ATOL = 1e-4


def keyframe_checksums(keyframes) -> dict:
    """Per-keyframe fingerprints: the triangulated landmark count, the sums
    of the keypoints' x and y over all slots, the sum of the valid
    landmarks in inverse range, p / |p|^2 (1/m: the far points' range is
    ill-conditioned, their inverse range is not), and the global
    descriptor's projection on a fixed unit vector."""
    dim = len(keyframes[0].global_desc)
    r = np.cos(np.arange(dim) * 1.618)
    r /= np.linalg.norm(r)
    f64 = lambda a: np.asarray(a, np.float64)

    def inv_sum(kf):
        p = f64(kf.landmarks_3d)[np.asarray(kf.valid)]
        return (p / (p * p).sum(1, keepdims=True)).sum(0).tolist()

    return {
        "landmarks": [int(kf.valid.sum()) for kf in keyframes],
        "kp_sum": [f64(kf.kp_xy).sum(0).tolist() for kf in keyframes],
        "lm_inv_sum": [inv_sum(kf) for kf in keyframes],
        "gd_proj": [float(f64(kf.global_desc) @ r) for kf in keyframes],
    }


def checksum_faults(got: dict, want: dict, width: int, height: int):
    """(faults, stats): the ways ``got`` departs from ``want`` beyond the
    tolerances above (empty when it agrees), and the largest and median
    per-keyframe differences."""
    if len(got["landmarks"]) != len(want["landmarks"]):
        return [f"{len(got['landmarks'])} keyframes, expected "
                f"{len(want['landmarks'])}"], {}
    n_want = np.asarray(want["landmarks"])
    d_n = np.abs(np.asarray(got["landmarks"]) - n_want)
    d_kp = np.abs(np.asarray(got["kp_sum"]) - np.asarray(want["kp_sum"]))
    d_lm = np.abs(np.asarray(got["lm_inv_sum"])
                  - np.asarray(want["lm_inv_sum"]))
    d_gd = np.abs(np.asarray(got["gd_proj"]) - np.asarray(want["gd_proj"]))
    kp_med, lm_med = float(np.median(d_kp.max(1))), float(
        np.median(d_lm.max(1)))
    checks = (
        ("landmark count", d_n > np.maximum(2, LANDMARK_COUNT_RTOL * n_want)),
        ("keypoint sum", (d_kp > 2 * np.asarray([width, height])).any(1)),
        ("landmark sum", (d_lm > 2 * LANDMARK_MAX_INV).any(1)),
        ("global descriptor", d_gd > GD_ATOL),
    )
    faults = [f"{name} differs at keyframes {np.flatnonzero(bad).tolist()}"
              for name, bad in checks if bad.any()]
    if kp_med > KP_MEDIAN_PX:
        faults.append(f"median keypoint-sum difference {kp_med} px")
    if lm_med > LM_MEDIAN_INV:
        faults.append(f"median landmark-sum difference {lm_med} 1/m")
    stats = dict(landmark_count_max_diff=int(d_n.max()),
                 kp_sum_max_px=float(d_kp.max()), kp_sum_median_px=kp_med,
                 lm_inv_sum_max=float(d_lm.max()), lm_inv_sum_median=lm_med,
                 gd_proj_max_diff=float(d_gd.max()))
    return faults, stats


class Prepared(NamedTuple):
    data: sim.SimData
    fp: FrontendParams
    intr: CameraIntrinsics
    steps: list                     # per keyframe step: OmniLoopCam entries
    render_s: float                 # host seconds spent rendering
    kf_every: int                   # frames per keyframe step


def prepare(num_drones: int = 5, num_frames: int = 30, kf_every: int = 2,
            seed: int = 7, height: int = 208, width: int = 400) -> Prepared:
    """Steps 1-2: simulate and render every keyframe step (host numpy)."""
    data = sim.generate(sim.SimParams(
        num_drones=num_drones, num_frames=num_frames, seed=seed,
        radius_range=(2.0, 3.5), z_range=(0.8, 2.0)))
    fp = FrontendParams(height=height, width=width, match_index_dist=4,
                        netvlad_thres=0.35)
    intr = CameraIntrinsics(fx=220, fy=220, cx=fp.width / 2,
                            cy=fp.height / 2)
    t0 = time.perf_counter()
    steps = render_steps(data, fp, intr, kf_every)
    return Prepared(data, fp, intr, steps, time.perf_counter() - t0,
                    kf_every)


def run_steps(cam: OmniLoopCam, fp: FrontendParams, steps):
    """Steps 3-4 on a fresh PlaceDB: (keyframes, valid keypoints per
    keyframe, top-1 indices, top-1 similarities, extraction ms per step)."""
    dev = cam.device
    db = placedb.make_placedb(fp.max_db_size, fp.global_desc_dim, dev)
    keyframes, keypoints, top_idx, top_sim, step_ms = [], [], [], [], []
    for entries in steps:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        kfs = cam.on_fisheye_frames_batch(entries)   # ends in a download
        step_ms.append((time.perf_counter() - t0) * 1e3)
        keypoints.extend(cam.last_kp_valid.reshape(len(kfs), -1).sum(1))
        with record_function("frontend/retrieval"):
            descs = torch.from_numpy(
                np.stack([kf.global_desc for kf in kfs])).to(dev)
            idx, sims = placedb.query_batch(
                db, descs, [kf.drone_id for kf in kfs],
                [kf.frame_id for kf in kfs],
                match_index_dist=fp.match_index_dist)
            top_idx.append(idx.cpu().numpy())
            top_sim.append(sims.cpu().numpy())
            for kf, desc in zip(kfs, descs):
                db = placedb.add(db, desc, kf.drone_id, kf.frame_id)
        keyframes.extend(kfs)
    return (keyframes, np.asarray(keypoints, np.int64),
            np.concatenate(top_idx), np.concatenate(top_sim),
            np.asarray(step_ms))


def frontend_entry(device="cuda", num_drones: int = 5, num_frames: int = 30,
                   kf_every: int = 2, seed: int = 7, height: int = 208,
                   width: int = 400, prep=None) -> FrontendResult:
    """Run steps 1-5 of the front-end path and return the scored result.
    ``prep``: steps 1-2, ``prepare`` at the same arguments (rendered here
    if None)."""
    dev = resolve_device(device)
    if prep is None:
        prep = prepare(num_drones, num_frames, kf_every, seed, height, width)
    cam = OmniLoopCam(params=prep.fp, intrinsics=prep.intr,
                      baseline=BASELINE, device=dev)
    k2_0, k3_0 = grid_nms.launches, retrieval_top1.launches
    keyframes, keypoints, top1_idx, top1_sim, step_ms = run_steps(
        cam, prep.fp, prep.steps)
    k2, k3 = grid_nms.launches - k2_0, retrieval_top1.launches - k3_0
    precision, confident = top1_precision(
        prep.data.gt, keyframes, top1_idx, top1_sim, prep.fp.netvlad_thres,
        guard=prep.fp.match_index_dist * kf_every)
    steady = step_ms[STEADY_STEP:] if len(step_ms) > STEADY_STEP else step_ms
    return FrontendResult(
        keyframes=keyframes, keypoints=keypoints,
        landmarks=np.asarray([int(kf.valid.sum()) for kf in keyframes]),
        top1_idx=top1_idx, top1_sim=top1_sim,
        precision=precision, confident=confident, step_ms=step_ms,
        views_per_s=4 * num_drones * len(steady) / (steady.sum() / 1e3),
        k2_launches=k2, k3_launches=k3, render_s=prep.render_s)


def summary(res: FrontendResult) -> dict:
    """The scalar scores of a run, for one JSON line."""
    return {
        "keyframes": len(res.keyframes),
        "keypoints": int(res.keypoints.sum()),
        "landmarks": int(res.landmarks.sum()),
        "keypoints_per_kf": float(res.keypoints.mean()),
        "landmarks_per_kf": float(res.landmarks.mean()),
        "top1_precision": res.precision, "confident_queries": res.confident,
        "step_ms_median": float(np.median(res.step_ms)),
        "views_per_s": float(res.views_per_s),
        "k2_launches": res.k2_launches, "k3_launches": res.k3_launches,
        "render_s": res.render_s,
    }


if __name__ == "__main__":
    print(json.dumps(summary(frontend_entry())))
