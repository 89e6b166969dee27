"""Driver of the ``rgbd_keyframes`` traffic: RGB-D keyframe steps of the
swarm's front-end (the upstream RealSense set-up, PINHOLE_DEPTH keyframes)
with retrieval against a full place database.

Set-up: the frozen simulator draws the swarm's flight from the seed, the
frozen renderer draws a textured room (its seed from the run's), and
``frozen.depth_world`` renders a pool of distinct steps on the device
(every drone's forward-looking 640 x 480 infrared view, uint8, with its
depth map, uint16 millimetres with noise and holes), handed to the program
as host arrays; the program's ``LoopCam`` loads the configuration's
checkpoints; the program's PlaceDB is filled to its capacity with seeded
unit descriptors of long-past keyframes, as after a long flight; two steps
warm every shape. A unit is one step: ``LoopCam.on_depth_frames_batch`` on
every drone's frame (one view a drone), then ``placedb.query_batch`` (K3)
with the results read back to the host, then ``placedb.add`` of each
keyframe. One caller (the swarm's keyframe batcher); the steps cycle
through the pool with frame ids rising by ``kf_every`` a step. A unit
returns its steps, views and the program's depth counters' increments
(``depth_lookups``, ``depth_rejected``).

The check, after the window: the reference (``reference/rgbd.py``) runs
each pool step once in float32 with TF32 off; every step's output is
compared with its pool step's. A step that does not return one keyframe a
drone, in drone order, reads infinite on every number. The numbers, each
the worst over the run:

- ``kp_gap``: as the ``keyframes`` driver defines it, on each drone's one
  view: how far a keypoint that one side keeps and the other does not lies
  on the wrong side of the reference's top-K cut in the reference's heat
  map, or, where the program's keypoint sits a pixel from the reference's,
  how far the program's pixel lies below the reference's maximum;
- ``desc_ulps``: the local descriptors of the keypoints both keep, and the
  global descriptors, in units of the float16 spacing at each descriptor's
  largest entry (the unit of the stereo cells);
- ``landmark_flips``: keypoints both keep whose landmark one side lifts
  and the other does not, most in one step;
- ``landmark_px``: for the keypoints whose landmark both sides lift, how
  far the program's landmark projects from the reference's into the view,
  in pixels (x and y), the most over the run;
- ``depth_gap_mm``: for the same landmarks, the difference of their
  camera-frame depths in millimetres, the most over the run: a landmark
  scaled along its ray projects to the same pixel;
- ``retrieval_gap``: as the ``keyframes`` driver defines it: each query's
  best similarity (float64, against the database as seeded and as the
  program filled it) less that of the row the program returned, or the
  error of the similarity it reported, whichever is larger.
"""
from __future__ import annotations

import hashlib
import math
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.drivers import keyframes
from benchmark.frozen import depth_world, image_world, simulator
from benchmark.reference import frontend as ref
from benchmark.reference import rgbd

NUMBERS = ("kp_gap", "desc_ulps", "landmark_flips", "landmark_px",
           "depth_gap_mm")


def project(pts, fe: dict):
    """((N, 2) pixels, (N,) camera-frame depths) of the body-frame
    landmarks ``pts`` (N, 3) in the configuration's pinhole camera."""
    cam = np.asarray(pts, np.float64) @ np.asarray(ref.CAM_TO_BODY)
    z = cam[:, 2]
    return np.stack([fe["fx"] * cam[:, 0] / z + fe["cx"],
                     fe["fy"] * cam[:, 1] / z + fe["cy"]], -1), z


def pair_keypoints(pxy, pv, rxy, rv, ranked, heat, K: int):
    """(kp_gap, program indices, reference indices) of one view: each kept
    keypoint paired with the other side's nearest, within 0.5 px the same
    keypoint, within 1.5 px the suppression's maximum moved to a
    neighbouring pixel (the ``keyframes`` driver's rule); the pairs are
    those within 0.5 px."""
    H, W = heat.shape
    dist = np.linalg.norm(pxy[:, None] - rxy[None], axis=-1)
    dist[:, ~rv] = np.inf
    dist[~pv] = np.inf
    near = dist.argmin(1)
    dn = dist[np.arange(K), near]
    both = pv & (dn <= 0.5)
    moved = pv & (dn > 0.5) & (dn <= 1.5)
    paired = np.zeros(K, bool)
    paired[near[both | moved]] = True
    cut = ranked[K - 1]
    nxt = ranked[K] if len(ranked) > K else 0.0
    gaps = [0.0]
    for i in np.flatnonzero(moved):
        qx, qy = (int(round(float(c))) for c in rxy[near[i]])
        px, py = min(
            ((qx + dx, qy + dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
             if dx or dy),
            key=lambda c: np.linalg.norm(
                keyframes.centroid(heat, c[1], c[0]) - pxy[i]))
        gaps.append(float(heat[qy, qx]) - float(
            heat[min(max(py, 0), H - 1), min(max(px, 0), W - 1)]))
    for i in np.flatnonzero(pv & ~both & ~moved):
        x, y = (int(round(float(c))) for c in pxy[i])
        gaps.append(float(cut) - float(
            heat[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].max()))
    for i in np.flatnonzero(rv & ~paired):
        x, y = (int(round(float(c))) for c in rxy[i])
        gaps.append(float(heat[max(y - 1, 0):y + 2,
                               max(x - 1, 0):x + 2].max()) - float(nxt))
    return max(gaps), np.flatnonzero(both), near[both]


class Driver(keyframes.Driver):
    """The ``keyframes`` driver's database, retrieval replay and
    bookkeeping, with RGB-D frames, the program's RGB-D path and its
    reference."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import omniswarm_torch
        from pathlib import Path

        from omniswarm_torch.config import FrontendParams
        from omniswarm_torch.ops import placedb
        from omniswarm_torch.swarm.loop_cam import CameraIntrinsics, LoopCam

        fe = config["frontend"]
        self.fe = dict(fe)
        self.root = Path(omniswarm_torch.__file__).resolve().parents[1]
        self.D = config["swarm"]["drones"]
        self.seed = int(seed) % (2 ** 62)
        self.device = torch.device(device)
        self.kf_every = int(traffic["kf_every"])
        H, W = fe["height"], fe["width"]
        if (fe["cx"], fe["cy"]) != (W / 2, H / 2):
            raise ValueError("the renderer's principal point is the centre")
        self.depth_scale = float(config["depth"]["unit_m"])
        self.fp = FrontendParams(
            width=W, height=H, max_keypoints=fe["max_keypoints"],
            superpoint_thres=fe["superpoint_thres"], nms_dist=fe["nms_dist"],
            local_desc_dim=fe["local_desc_dim"],
            global_desc_dim=fe["global_desc_dim"],
            netvlad_thres=fe["netvlad_thres"],
            match_index_dist=fe["match_index_dist"],
            max_db_size=fe["max_db_size"])

        t0 = time.perf_counter()
        steps = max(1, int(traffic["pool_views"]) // self.D)
        self.sim = simulator.generate(simulator.SimParams(
            num_drones=self.D, num_frames=self.kf_every * steps,
            seed=self.seed, radius_range=(2.0, 3.5), z_range=(0.8, 2.0)))
        world = image_world.RoomWorld(half=6.0, seed=self.seed % (2 ** 31))
        self.pool = depth_world.render_rgbd(
            self.sim.gt, range(0, self.kf_every * steps, self.kf_every),
            fe["fx"], fe["fy"], H, W, world, config["depth"], self.seed,
            self.device)

        t1 = time.perf_counter()
        self.cam = LoopCam(
            params=self.fp, device=self.device,
            intrinsics=CameraIntrinsics(fx=fe["fx"], fy=fe["fy"],
                                        cx=fe["cx"], cy=fe["cy"]),
            superpoint_weights=self.root / fe["superpoint_weights"],
            netvlad_weights=self.root / fe["netvlad_weights"])
        t2 = time.perf_counter()
        self._placedb = placedb
        N = fe["max_db_size"]
        self.db = placedb.make_placedb(N, fe["global_desc_dim"], self.device)
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

    def entries(self, s: int):
        j = s % len(self.pool)
        frame = self.kf_every * s
        vio = self.sim.vio[self.kf_every * j]
        return [(d, frame, float(frame), vio[d]) + self.pool[j][d]
                for d in range(self.D)]

    def unit(self) -> dict:
        s = self.step_no
        self.step_no += 1
        before = (self.cam.depth_lookups, self.cam.depth_rejected)
        kfs = self.cam.on_depth_frames_batch(self.entries(s),
                                             depth_scale=self.depth_scale)
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
            (kf.kp_xy, kf.local_desc, kf.valid, kf.global_desc,
             kf.landmarks_3d, kf.drone_id) for kf in kfs], kp_valid, idx,
            sims))
        return {"steps": 1, "views": self.D,
                "depth_lookups": self.cam.depth_lookups - before[0],
                "depth_rejected": self.cam.depth_rejected - before[1]}

    # -- the check ---------------------------------------------------------

    def reference_pool(self):
        """The reference's output of every pool step (exact float32)."""
        sp = ref.load_weights(self.root / self.fe["superpoint_weights"],
                              self.device)
        nv = ref.load_weights(self.root / self.fe["netvlad_weights"],
                              self.device)
        return [rgbd.step(sp, nv, self.fe, np.stack([g for g, _ in views]),
                          np.stack([d for _, d in views]), self.device,
                          self.depth_scale)
                for views in self.pool]

    def check(self) -> dict:
        if any([kf[5] for kf in kfs] != list(range(self.D))
               for _s, kfs, *_ in self.outputs):
            return dict.fromkeys(NUMBERS + ("retrieval_gap",), math.inf)
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            pool = self.reference_pool()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        worst = dict.fromkeys(NUMBERS, 0.0)
        judged = {}
        for s, kfs, kp_valid, _idx, _sims in self.outputs:
            j = s % len(pool)
            # a step whose outputs equal, byte for byte, an earlier step's
            # of the same pool step has that step's verdict
            digest = hashlib.sha1(kp_valid.tobytes())
            for kf in kfs:
                for a in kf[:5]:
                    digest.update(np.ascontiguousarray(a).tobytes())
            key = (j, digest.hexdigest())
            if key not in judged:
                judged[key] = self.judge_step(kfs, kp_valid, pool[j])
            for k, v in judged[key].items():
                worst[k] = max(worst[k], v)
        worst["retrieval_gap"] = self.judge_retrieval()
        return worst

    def judge_step(self, kfs, kp_valid, r) -> dict:
        """The step's keypoints, descriptors and landmarks against the
        reference's (one pool step)."""
        K = self.fe["max_keypoints"]
        out = dict.fromkeys(NUMBERS, 0.0)
        for d, (xy, desc, ok, gd, lms, _drone) in enumerate(kfs):
            out["desc_ulps"] = max(out["desc_ulps"], float(np.max(
                np.abs(gd.astype(np.float64) - r.gdesc[d])
                / keyframes.ulp16(np.abs(r.gdesc[d]).max()))))
            gap, pi, ri = pair_keypoints(xy, kp_valid[d], r.xy[d],
                                         r.kp_valid[d], r.ranked[d],
                                         r.heat[d], K)
            out["kp_gap"] = max(out["kp_gap"], gap)
            if not len(pi):
                continue
            rd = r.desc[d][ri].astype(np.float64)
            out["desc_ulps"] = max(out["desc_ulps"], float(np.max(
                np.abs(desc[pi].astype(np.float64) - rd)
                / keyframes.ulp16(np.abs(rd).max(1, keepdims=True)))))
            pok, rok = ok[pi], r.ok[d][ri]
            out["landmark_flips"] += float(np.sum(pok != rok))
            both = pok & rok
            if both.any():
                ppx, pz = project(lms[pi][both], self.fe)
                rpx, rz = project(r.pts[d][ri][both], self.fe)
                out["landmark_px"] = max(out["landmark_px"],
                                         float(np.max(np.abs(ppx - rpx))))
                out["depth_gap_mm"] = max(out["depth_gap_mm"], float(
                    1e3 * np.max(np.abs(pz - rz))))
        return out
