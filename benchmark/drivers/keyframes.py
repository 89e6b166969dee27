"""Driver of the ``keyframes`` traffic: keyframe steps of the swarm's
visual front-end with retrieval against a full place database.

Set-up: the frozen simulator draws the swarm's flight from the seed and
the frozen renderer draws a textured room (its seed from the run's) and
renders a pool of distinct steps (every drone's 4-direction stereo rig,
uint8) on the device, handed to the program as host arrays; the program's ``OmniLoopCam`` loads the configuration's
checkpoints; the program's PlaceDB is filled to its capacity with seeded
unit descriptors of long-past keyframes (``placedb.add``), as after a long
flight; two steps warm every shape. A unit is one step, as the port's
``frontend_entry.run_steps`` runs it: ``OmniLoopCam.on_fisheye_frames_batch``
on every drone's keyframe (8 x drones views), then ``placedb.query_batch``
(K3) with the results read back to the host, then ``placedb.add`` of each
keyframe. One caller (the swarm's keyframe batcher); the steps cycle
through the pool with frame ids rising by ``kf_every`` a step.

The check, after the window: the reference (``reference/frontend.py``)
runs each pool step once in float32 with TF32 off; every step's output is
compared with its pool step's. The numbers, each the worst over the run:

- ``kp_gap``: in the reference's heat map, how far a left-view keypoint
  that one side keeps and the other does not lies on the wrong side of the
  reference's top-K cut, or, where the program's keypoint sits a pixel
  from the reference's, how far the program's pixel lies below the
  reference's maximum;
- ``desc_ulps``: the local descriptors of the keypoints both keep, and the
  keyframes' global descriptors, in units of the float16 spacing (the wire
  format) at each descriptor's largest entry;
- ``landmark_flips``: keypoints both keep whose landmark one side
  triangulates and the other does not, most in one step (all its views);
- ``landmark_px``: for the keypoints whose landmark both sides
  triangulate, how far the program's landmark projects from the
  reference's, in pixels, into the left view (x and y) and into the
  right view (x, which holds the disparity and so the depth), the most
  over the run: a well-conditioned form of the landmark, where its depth
  alone is not for far points;
- ``retrieval_gap``: each query's best similarity (float64, the program's
  own query against the database as seeded and as the program filled it
  with its keyframes) less that of the row the program returned, or the
  error of the similarity it reported, whichever is larger.
"""
from __future__ import annotations

import hashlib
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.frozen import image_world, simulator
from benchmark.reference import frontend as ref


def centroid(heat: np.ndarray, y: int, x: int) -> np.ndarray:
    """The heat-weighted centroid (x, y) of pixel (y, x)'s 3 x 3
    neighbourhood, indices clamped at the border."""
    H, W = heat.shape
    num, den = np.zeros(2), 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            w = max(float(heat[min(max(y + dy, 0), H - 1),
                               min(max(x + dx, 0), W - 1)]), 0.0)
            num += w * np.array([x + dx, y + dy])
            den += w
    return num / max(den, 1e-12)


def project(pts, fe: dict, view=None) -> np.ndarray:
    """(N, 3) pixels (left x, left y, right x) of the body-frame landmarks
    ``pts`` (N, 3) in the rig of ``fe``, first turned back by the yaw of
    rig direction ``view`` when it is given (a merged keyframe's
    landmarks)."""
    p = np.asarray(pts, np.float64)
    if view is not None:
        c, s = np.cos(ref.VIEW_YAWS[view]), np.sin(ref.VIEW_YAWS[view])
        p = np.stack([c * p[:, 0] + s * p[:, 1],
                      -s * p[:, 0] + c * p[:, 1], p[:, 2]], -1)
    cam = p @ np.asarray(ref.CAM_TO_BODY)        # body -> camera
    fx, fy = fe["fx"], fe["fy"]
    cx, cy, z = fe["width"] / 2, fe["height"] / 2, cam[:, 2]
    return np.stack([fx * cam[:, 0] / z + cx, fy * cam[:, 1] / z + cy,
                     fx * (cam[:, 0] - fe["baseline_m"]) / z + cx], -1)


def ulp16(x: np.ndarray) -> np.ndarray:
    """The float16 spacing at |x| (normal range; 2^-24 below it)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -14)
    return 2.0 ** (np.floor(np.log2(a)) - 10)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import omniswarm_torch
        from omniswarm_torch.config import FrontendParams
        from omniswarm_torch.ops import placedb
        from omniswarm_torch.swarm.loop_cam import (CameraIntrinsics,
                                                    OmniLoopCam)

        fe = config["frontend"]
        self.fe = dict(fe)
        # the checkout that holds the program and the weight files
        self.root = Path(omniswarm_torch.__file__).resolve().parents[1]
        self.D = config["swarm"]["drones"]
        self.seed = int(seed) % (2 ** 62)
        self.device = torch.device(device)
        self.kf_every = int(traffic["kf_every"])
        H, W = fe["height"], fe["width"]
        self.fp = FrontendParams(
            width=W, height=H, max_keypoints=fe["max_keypoints"],
            superpoint_thres=fe["superpoint_thres"], nms_dist=fe["nms_dist"],
            local_desc_dim=fe["local_desc_dim"],
            global_desc_dim=fe["global_desc_dim"],
            netvlad_thres=fe["netvlad_thres"],
            match_index_dist=fe["match_index_dist"],
            max_db_size=fe["max_db_size"])
        self.fe["triangulate_max_err"] = self.fp.triangulate_max_err
        intr = CameraIntrinsics(fx=fe["fx"], fy=fe["fy"], cx=W / 2,
                                cy=H / 2)

        # the pool: distinct steps rendered from the seed
        t0 = time.perf_counter()
        steps = max(1, int(traffic["pool_views"]) // (8 * self.D))
        self.sim = simulator.generate(simulator.SimParams(
            num_drones=self.D, num_frames=self.kf_every * steps,
            seed=self.seed, radius_range=(2.0, 3.5), z_range=(0.8, 2.0)))
        world = image_world.RoomWorld(half=6.0, seed=self.seed % (2 ** 31))
        self.pool = image_world.render_steps(
            self.sim.gt, range(0, self.kf_every * steps, self.kf_every),
            fe["fx"], fe["fy"], H, W, fe["baseline_m"], world, self.seed,
            self.device)

        t1 = time.perf_counter()
        self.cam = OmniLoopCam(params=self.fp, intrinsics=intr,
                               baseline=fe["baseline_m"], device=self.device)
        t2 = time.perf_counter()
        self._placedb = placedb
        N, G = fe["max_db_size"], fe["global_desc_dim"]
        self.db = placedb.make_placedb(N, G, self.device)
        for i, row in enumerate(self.filler()):
            self.db = placedb.add(self.db, row, i % self.D, -1000 * N + i)
        self.outputs = []
        self.step_no = 0
        t3 = time.perf_counter()
        for _ in range(int(traffic["warm_steps"])):
            self.unit()
        print(f"setup: render {t1 - t0:.3f} s, checkpoints {t2 - t1:.3f} s,"
              f" database {t3 - t2:.3f} s, warm steps "
              f"{time.perf_counter() - t3:.3f} s", file=sys.stderr)

    def filler(self) -> torch.Tensor:
        """The database's seeded rows: (capacity, G) unit vectors."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 7919 + 1) % (2 ** 63))
        rows = torch.randn((self.fe["max_db_size"],
                            self.fe["global_desc_dim"]), generator=gen,
                           device=self.device)
        return rows / rows.norm(dim=1, keepdim=True)

    def entries(self, s: int):
        j = s % len(self.pool)
        frame = self.kf_every * s
        vio = self.sim.vio[self.kf_every * j]
        return [(d, frame, float(frame), vio[d], self.pool[j][d])
                for d in range(self.D)]

    def unit(self) -> dict:
        s = self.step_no
        self.step_no += 1
        kfs = self.cam.on_fisheye_frames_batch(self.entries(s))
        kp_valid = self.cam.last_kp_valid
        with record_function("frontend/retrieval"):
            descs = torch.from_numpy(
                np.stack([kf.global_desc for kf in kfs])).to(self.device)
            idx, sims = self._placedb.query_batch(
                self.db, descs, [kf.drone_id for kf in kfs],
                [kf.frame_id for kf in kfs],
                match_index_dist=self.fp.match_index_dist)
            idx, sims = idx.cpu().numpy(), sims.cpu().numpy()
            for kf, desc in zip(kfs, descs):
                self.db = self._placedb.add(self.db, desc, kf.drone_id,
                                            kf.frame_id)
        self.outputs.append((s, [
            (kf.kp_xy.astype(np.float16), kf.local_desc.astype(np.float16),
             kf.valid, kf.global_desc, kf.landmarks_3d) for kf in kfs],
            kp_valid, idx, sims))
        return {"steps": 1, "views": 8 * self.D}

    @property
    def attempted(self) -> int:
        return len(self.outputs)

    failed = 0

    def release(self) -> None:
        self.cam = self.db = None
        torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def reference_pool(self):
        """The reference's output of every pool step (exact float32)."""
        sp = ref.load_weights(self.root / self.fe["superpoint_weights"],
                              self.device)
        nv = ref.load_weights(self.root / self.fe["netvlad_weights"],
                              self.device)
        out = []
        for pairs in self.pool:
            lefts = np.stack([p[0] for views in pairs for p in views])
            rights = np.stack([p[1] for views in pairs for p in views])
            out.append(ref.step(sp, nv, self.fe, lefts, rights, self.device))
        return out

    def check(self) -> dict:
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            pool = self.reference_pool()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        merged = [[kf[4] for kf in ref.merge(p, self.D)] for p in pool]
        worst = dict(kp_gap=0.0, desc_ulps=0.0, landmark_flips=0.0,
                     landmark_px=0.0)
        judged = {}
        for s, kfs, kp_valid, _idx, _sims in self.outputs:
            j = s % len(pool)
            # a step whose outputs equal, byte for byte, an earlier step's
            # of the same pool step has that step's verdict
            digest = hashlib.sha1(kp_valid.tobytes())
            for kf in kfs:
                for a in kf:
                    digest.update(np.ascontiguousarray(a).tobytes())
            key = (j, digest.hexdigest())
            if key not in judged:
                judged[key] = self.judge_step(kfs, kp_valid, pool[j],
                                              merged[j])
            for k, v in judged[key].items():
                worst[k] = max(worst[k], v)
        worst["retrieval_gap"] = self.judge_retrieval()
        return worst

    def judge_step(self, kfs, kp_valid, r, rmerged) -> dict:
        """The step's keypoints, descriptors and landmarks against the
        reference's (one pool step)."""
        K = self.fe["max_keypoints"]
        out = dict(kp_gap=0.0, desc_ulps=0.0, landmark_flips=0.0,
                   landmark_px=0.0)
        H, W = self.fe["height"], self.fe["width"]
        for d, (xy, desc, ok, gd, lms) in enumerate(kfs):
            gd_ref = rmerged[d]
            out["desc_ulps"] = max(out["desc_ulps"], float(np.max(
                np.abs(gd.astype(np.float64) - gd_ref))
                / ulp16(np.abs(gd_ref).max())))
            for v in range(4):
                b = 4 * d + v
                sl = slice(v * K, (v + 1) * K)
                pv = kp_valid.reshape(-1, K)[b]
                pxy = xy[sl].astype(np.float32)
                rxy = r.xy[b].astype(np.float32)
                rv = r.kp_valid[b]
                # pair each kept keypoint with the other side's nearest:
                # within 0.5 px the same keypoint, within 1.5 px the
                # suppression's maximum moved to a neighbouring pixel
                dist = np.linalg.norm(pxy[:, None] - rxy[None], axis=-1)
                dist[:, ~rv] = np.inf
                dist[~pv] = np.inf
                near = dist.argmin(1)
                dn = dist[np.arange(K), near]
                both = pv & (dn <= 0.5)
                moved = pv & (dn > 0.5) & (dn <= 1.5)
                paired = np.zeros(K, bool)
                paired[near[both | moved]] = True
                ranked, heat = r.ranked[b], r.heat[b]
                cut = ranked[K - 1]
                nxt = ranked[K] if len(ranked) > K else 0.0
                gaps = [0.0]
                for i in np.flatnonzero(moved):
                    # the program's pixel: the neighbour of the reference's
                    # whose centroid is nearest the program's keypoint
                    qx, qy = (int(round(float(c))) for c in rxy[near[i]])
                    px, py = min(
                        ((qx + dx, qy + dy) for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) if dx or dy),
                        key=lambda c: np.linalg.norm(
                            centroid(heat, c[1], c[0]) - pxy[i]))
                    gaps.append(float(heat[qy, qx]) - float(
                        heat[min(max(py, 0), H - 1), min(max(px, 0), W - 1)]))
                for i in np.flatnonzero(pv & ~both & ~moved):
                    # kept here, not by the reference: how far below its cut
                    x, y = (int(round(float(c))) for c in pxy[i])
                    win = heat[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
                    gaps.append(float(cut) - float(win.max()))
                for i in np.flatnonzero(rv & ~paired):
                    # kept by the reference, not here: how far above the
                    # best candidate it left out
                    x, y = (int(round(float(c))) for c in rxy[i])
                    gaps.append(float(heat[max(y - 1, 0):y + 2,
                                           max(x - 1, 0):x + 2].max())
                                - float(nxt))
                out["kp_gap"] = max(out["kp_gap"], max(gaps))
                pi, ri = np.flatnonzero(both), near[both]
                if len(pi):
                    rd = r.desc[b][ri].astype(np.float64)
                    pd = desc[sl][pi].astype(np.float64)
                    out["desc_ulps"] = max(out["desc_ulps"], float(np.max(
                        np.abs(pd - rd)
                        / ulp16(np.abs(rd).max(1, keepdims=True)))))
                    pok, rok = ok[sl][pi], r.ok[b][ri]
                    out["landmark_flips"] += float(np.sum(pok != rok))
                    both_ok = pok & rok
                    if both_ok.any():
                        out["landmark_px"] = max(out["landmark_px"], float(
                            np.max(np.abs(
                                project(lms[sl][pi][both_ok], self.fe, v)
                                - project(r.pts[b][ri][both_ok],
                                          self.fe)))))
        return out

    def judge_retrieval(self) -> float:
        """Replays the database in float64: the seeded rows, then every
        step's keyframes in the order the program added them."""
        dev = self.device
        db = self.filler().double()
        N = db.shape[0]
        drone = torch.tensor([i % self.D for i in range(N)], device=dev)
        frame = torch.tensor([-1000 * N + i for i in range(N)], device=dev)
        cursor, worst = N, 0.0
        mid = self.fp.match_index_dist
        for s, kfs, _kv, idx, sims in self.outputs:
            q = torch.tensor(np.stack([kf[3] for kf in kfs]),
                             dtype=torch.float64, device=dev)
            qd = torch.arange(self.D, device=dev)[:, None]
            qf = self.kf_every * s
            usable = ~((drone[None] == qd) & ((frame[None] - qf).abs() < mid))
            sim = torch.where(usable, q @ db.T, -math.inf)
            best = sim.max(1).values
            at = torch.gather(sim, 1, torch.as_tensor(
                idx, device=dev).long()[:, None])[:, 0]
            rep = torch.as_tensor(sims, dtype=torch.float64, device=dev)
            gap = torch.maximum(best - at, (rep - at).abs())
            worst = max(worst, float(gap.max()))
            for d in range(self.D):
                slot = cursor % N
                db[slot] = q[d]
                drone[slot], frame[slot] = d, qf
                cursor += 1
        return worst
