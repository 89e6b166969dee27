"""Keyframe descriptor builder: stereo views to a shareable KeyframeData.

Counterpart of ``omniswarm_tpu/swarm/loop_cam.py`` (:37-386): for a batch of
stereo pairs, SuperPoint keypoints with PCA descriptors on all views,
NetVLAD global descriptors of the left views, left/right mutual matching
and stereo triangulation to body-frame landmarks, then assembly into
``KeyframeData``. ``OmniLoopCam`` merges a 4-direction rig's views into one
keyframe per drone with each direction's landmarks yawed into the body
frame.

The batch runs on the device in true f32 (``core.precision.highp``: no TF32
in matmuls or cuDNN convolutions); uint8 images are normalised on the
device. Like the reference, which downloads them as f16, the pixel
coordinates, local and global descriptors and landmarks are rounded to f16
on the device, so the two packages hand out the same values; they are then
widened there (exactly) and leave it, with the masks, as one packed f32
buffer in one download, which the host merge takes views of.
Left out of the reference's LoopCam: the per-pair ``_extract_batch_fallback``
(for injected test extractors) and the batch padding to multiples of 4
(for XLA's compile cache); neither changes an output row of this path.
Intrinsics that carry a generic camera model (``ops.camera.CameraBearings``
around a pinhole, MEI or Kannala-Brandt model, the reference's :125-134)
lift the keypoints with that model's ``lift`` in the fused extraction.

The RGB-D path (``LoopCam.on_depth_frames_batch``, the reference's
PINHOLE_DEPTH keyframes) runs every drone's view as one batch too: the
depth lookup at each keypoint, the lift and the depth gate run on the
device, and the outputs leave it in float32 (the reference hands them out
unrounded) in one download. A RealSense z16 depth map (uint16
millimetres) travels as int16 and is scaled on the device. ``LoopCam``'s
SuperPoint runs the nine 3 x 3 convolutions on C1 (``models/superpoint.py``);
``OmniLoopCam``'s keeps them on cuDNN, whose bits its f16 outputs are held
to.

Besides the device stages' ``torch.profiler`` ranges (``frontend/netvlad``,
``frontend/matching``, ``frontend/triangulation``, ``frontend/depth_lift``),
a batch's host phases carry ranges: ``frontend/stage`` (gathering, stacking
and concatenating the views), ``frontend/upload`` (the views' copy to the
device), ``frontend/download`` (the outputs' one copy to the host) and
``frontend/merge`` (the split of that copy and the per-drone merge). Stage
and merge hold host numpy only, no torch op, so a profile's idle device
gaps inside them carry their names. ``LoopCam.depth_lookups`` and
``depth_rejected`` count, over the camera's life, the RGB-D keypoints
looked up in a depth map and those the depth gate dropped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from omniswarm_torch.config import FrontendParams
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.ops.matching import mutual_match
from omniswarm_torch.ops.triangulation import triangulate_stereo
from omniswarm_torch.swarm.comm import KeyframeData


@dataclass
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float

    def bearings(self, xy: np.ndarray) -> np.ndarray:
        """Pixel coords (K, 2) -> unit rays (K, 3) in camera frame
        (x right, y down, z forward)."""
        x = (xy[:, 0] - self.cx) / self.fx
        y = (xy[:, 1] - self.cy) / self.fy
        rays = np.stack([x, y, np.ones_like(x)], axis=1)
        return rays / np.linalg.norm(rays, axis=1, keepdims=True)

    def bearings_torch(self, xy: torch.Tensor) -> torch.Tensor:
        """The same on a tensor of pixel coords (..., 2)."""
        x = (xy[..., 0] - self.cx) / self.fx
        y = (xy[..., 1] - self.cy) / self.fy
        rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


# camera (x right, y down, z fwd) -> body (x fwd, y left, z up)
CAM_TO_BODY = np.array([[0.0, 0.0, 1.0],
                        [-1.0, 0.0, 0.0],
                        [0.0, -1.0, 0.0]])
# the RGB-D keyframe's depth gate, metres (open interval)
DEPTH_MIN_M, DEPTH_MAX_M = 0.3, 10.0


class LoopCam:
    """Stereo and RGB-D keyframe builder on one device (default the GPU).

    ``last_kp_valid`` holds the (B, K) validity of the SuperPoint keypoints
    of the last batch's left (or RGB-D) views (a KeyframeData's ``valid``
    marks triangulated or lifted landmarks, a subset).
    ``superpoint_weights`` / ``netvlad_weights``: checkpoint files in the
    bundled ones' layout (default the bundled files).
    """

    def __init__(self, *, params: Optional[FrontendParams] = None,
                 intrinsics: Optional[CameraIntrinsics] = None,
                 baseline: float = 0.12, device="cuda",
                 superpoint_weights=None, netvlad_weights=None):
        from omniswarm_torch.models import netvlad, superpoint

        self.p = params or FrontendParams()
        self.intr = intrinsics or CameraIntrinsics(
            fx=0.5 * self.p.width, fy=0.5 * self.p.width,
            cx=self.p.width / 2, cy=self.p.height / 2)
        self.baseline = baseline
        self.device = resolve_device(device)
        if self.p.global_desc_dim != netvlad.BUNDLED_OUT_DIM:
            raise ValueError(
                f"global_desc_dim {self.p.global_desc_dim}: the bundled "
                f"NetVLAD checkpoint gives {netvlad.BUNDLED_OUT_DIM}")
        self._kp = superpoint.pretrained_extractor(
            self.device, path=superpoint_weights or superpoint.DEFAULT_WEIGHTS,
            max_keypoints=self.p.max_keypoints,
            threshold=self.p.superpoint_thres, nms_dist=self.p.nms_dist,
            pca_dim=self.p.local_desc_dim)
        self._gd = netvlad.pretrained_global_extractor(
            self.device, path=netvlad_weights or netvlad.DEFAULT_WEIGHTS)
        self._cam_to_body = torch.tensor(CAM_TO_BODY, dtype=torch.float32,
                                         device=self.device)
        self.last_kp_valid: Optional[np.ndarray] = None
        self.depth_lookups = 0
        self.depth_rejected = 0

    def _bearings(self, xy: torch.Tensor) -> torch.Tensor:
        """Unit rays (..., 3) of pixel coords (..., 2): the generic camera
        model's ``lift`` when the intrinsics carry one, else pinhole."""
        camera = getattr(self.intr, "camera", None)
        if camera is None:
            return self.intr.bearings_torch(xy)
        rays = camera.lift(xy.reshape(-1, 2)).reshape(xy.shape[:-1] + (3,))
        return rays / torch.clamp(
            torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-9)

    @torch.no_grad()
    def _extract_device(self, lefts: np.ndarray, rights: np.ndarray):
        """The fused batch on the device; f16 outputs (and bool masks)."""
        B = lefts.shape[0]
        with record_function("frontend/stage"):
            wire = np.uint8 if lefts.dtype == np.uint8 else np.float32
            imgs = np.ascontiguousarray(
                np.concatenate([lefts, rights], 0).astype(wire, copy=False))
        imgs = torch.from_numpy(imgs)       # a torch op: outside the stage
        with record_function("frontend/upload"):
            imgs = imgs.to(self.device)
        imgs = imgs[:, None]
        if imgs.dtype == torch.uint8:
            imgs = imgs.to(torch.float32) * (1.0 / 255.0)
        xy, _scores, desc, valid = self._kp(imgs)
        with record_function("frontend/netvlad"):
            gdesc = self._gd(imgs[:B])
        xy_l, xy_r = xy[:B], xy[B:]
        with record_function("frontend/matching"):
            m = mutual_match(desc[:B], desc[B:], valid[:B], valid[B:],
                             min_similarity=0.5)
            xy_rm = torch.gather(xy_r, 1,
                                 m.idx_b[..., None].expand(-1, -1, 2))
        with record_function("frontend/triangulation"):
            pts, err = triangulate_stereo(self._bearings(xy_l),
                                          self._bearings(xy_rm),
                                          self.baseline)
            depth = pts[..., 2]
            finite = torch.isfinite(pts).all(-1)
            ok = (m.mask & finite & (err < self.p.triangulate_max_err)
                  & (depth > 0.3) & (depth < 30.0))
            pts = torch.where(finite[..., None], pts, 0.0)
            pts_body = torch.where(ok[..., None],
                                   pts @ self._cam_to_body.T, 0.0)
        half = torch.float16
        return (xy_l.to(half), desc[:B].to(half), gdesc.to(half),
                pts_body.to(half), ok, valid[:B])

    @staticmethod
    def _pack_stereo(out) -> torch.Tensor:
        """``_extract_device``'s outputs as one (B, K * (2 + C + 3 + 2) + G)
        float32 buffer in ``_depth_device``'s layout: the f16 values widened
        (exactly) on the device, the masks as 0 / 1."""
        xy, desc, gdesc, pts_body, ok, valid = out
        B, half = xy.shape[0], torch.float16
        return torch.cat([xy.reshape(B, -1), desc.reshape(B, -1),
                          pts_body.reshape(B, -1), ok.to(half),
                          valid.to(half), gdesc], 1).to(torch.float32)

    def extract_stereo_batch(self, lefts: np.ndarray, rights: np.ndarray):
        """Run the front-end on B stereo pairs.

        lefts/rights: (B, H, W) grayscale, uint8 or in [0, 1]. Returns numpy
        (kp_xy (B,K,2), local_desc (B,K,C), global_desc (B,G),
        landmarks_body (B,K,3), valid (B,K)); kp_xy, local_desc and
        landmarks_body are views of the one float32 download.
        """
        with highp():
            packed = self._pack_stereo(self._extract_device(
                np.asarray(lefts), np.asarray(rights)))
        with record_function("frontend/download"):
            packed = packed.cpu().numpy()
        with record_function("frontend/merge"):
            B, (K, C) = len(packed), (self.p.max_keypoints,
                                      self.p.local_desc_dim)
            xy, desc, pts, ok, kp_valid, gdesc = np.split(
                packed, np.cumsum([2 * K, C * K, 3 * K, K, K]), axis=1)
            ok, self.last_kp_valid = ok > 0.5, kp_valid > 0.5
            gdesc = gdesc / np.maximum(
                np.linalg.norm(gdesc, axis=-1, keepdims=True), 1e-8)
            return (xy.reshape(B, K, 2), desc.reshape(B, K, C), gdesc,
                    pts.reshape(B, K, 3), ok)

    def on_stereo_frame(self, drone_id: int, frame_id: int, t: float,
                        vio_pose: np.ndarray, left: np.ndarray,
                        right: np.ndarray) -> KeyframeData:
        """Stereo keyframe: triangulate matched L/R features.

        left/right: (H, W) grayscale in [0, 1] (or uint8).
        """
        xy, desc, gdesc, pts_body, ok = self.extract_stereo_batch(
            np.asarray(left)[None], np.asarray(right)[None])
        return KeyframeData(
            drone_id=drone_id, frame_id=frame_id, t=t,
            pose=np.asarray(vio_pose, np.float32),
            global_desc=gdesc[0],
            kp_xy=xy[0],
            landmarks_3d=pts_body[0],
            local_desc=desc[0],
            valid=ok[0])

    def on_depth_frame(self, drone_id: int, frame_id: int, t: float,
                       vio_pose: np.ndarray, gray: np.ndarray,
                       depth: np.ndarray) -> KeyframeData:
        """RGB-D keyframe of one frame: ``on_depth_frames_batch`` of one
        entry."""
        [kf] = self.on_depth_frames_batch(
            [(drone_id, frame_id, t, vio_pose, gray, depth)])
        return kf

    def on_depth_frames_batch(self, entries: Sequence[tuple],
                              depth_scale: float = 1e-3) -> list:
        """RGB-D keyframes of many frames as one device batch: each view's
        keypoints back-projected through its depth map (the reference's
        PINHOLE_DEPTH path, loop_cam.cpp:231-339).

        entries: (drone_id, frame_id, t, vio_pose, gray, depth) tuples, all
        views of one size; gray (H, W) uint8 or in [0, 1]; depth (H, W)
        float metres, or uint16 millimetres (the RealSense z16 stream)
        scaled by ``depth_scale`` on the device. A keypoint takes the depth
        at its rounded pixel (half to even) and keeps its landmark only
        where that depth lies in (DEPTH_MIN_M, DEPTH_MAX_M): a 0 (a hole)
        drops it. Returns one float32 KeyframeData an entry.
        """
        with record_function("frontend/stage"):
            grays = np.stack([np.asarray(e[4]) for e in entries])
            depths = np.stack([np.asarray(e[5]) for e in entries])
            wire = np.uint8 if grays.dtype == np.uint8 else np.float32
            grays = np.ascontiguousarray(grays.astype(wire, copy=False))
            raw = depths.dtype == np.uint16
            # uint16 travels as int16, which every torch op takes
            depths = np.ascontiguousarray(
                depths.view(np.int16) if raw
                else depths.astype(np.float32, copy=False))
        grays, depths = torch.from_numpy(grays), torch.from_numpy(depths)
        with record_function("frontend/upload"):
            grays, depths = grays.to(self.device), depths.to(self.device)
        with highp():
            packed = self._depth_device(grays, depths,
                                        depth_scale if raw else None)
        with record_function("frontend/download"):
            packed = packed.cpu().numpy()
        with record_function("frontend/merge"):
            K, C = self.p.max_keypoints, self.p.local_desc_dim
            xy, desc, pts, ok, kp_valid, gdesc = np.split(
                packed, np.cumsum([2 * K, C * K, 3 * K, K, K]), axis=1)
            ok, kp_valid = ok > 0.5, kp_valid > 0.5
            self.last_kp_valid = kp_valid
            self.depth_lookups += int(kp_valid.sum())
            self.depth_rejected += int((kp_valid & ~ok).sum())
            return [KeyframeData(
                drone_id=drone_id, frame_id=frame_id, t=t,
                pose=np.asarray(vio_pose, np.float32),
                global_desc=gdesc[i], kp_xy=xy[i].reshape(K, 2),
                landmarks_3d=pts[i].reshape(K, 3),
                local_desc=desc[i].reshape(K, C), valid=ok[i])
                for i, (drone_id, frame_id, t, vio_pose, _g, _d)
                in enumerate(entries)]

    @torch.no_grad()
    def _depth_device(self, grays: torch.Tensor, depths: torch.Tensor,
                      depth_scale: Optional[float]) -> torch.Tensor:
        """The RGB-D batch on the device: (B, K * (2 + C + 3 + 2) + G)
        float32 rows of keypoints, local descriptors, body-frame landmarks,
        landmark validity, keypoint validity and global descriptors.
        ``depth_scale``: metres a unit of raw int16-carried uint16 depths,
        None for float metres."""
        B, H, W = depths.shape
        imgs = grays[:, None]
        if imgs.dtype == torch.uint8:
            imgs = imgs.to(torch.float32) * (1.0 / 255.0)
        xy, _scores, desc, valid = self._kp(imgs)
        with record_function("frontend/netvlad"):
            gdesc = self._gd(imgs)
        with record_function("frontend/depth_lift"):
            xi = torch.round(xy[..., 0]).long().clamp(0, W - 1)
            yi = torch.round(xy[..., 1]).long().clamp(0, H - 1)
            z = torch.gather(depths.reshape(B, -1), 1, yi * W + xi)
            if depth_scale is not None:
                z = (z.to(torch.int32) & 0xFFFF).to(torch.float32) \
                    * depth_scale
            rays = self._bearings(xy)
            pts = rays * (z / torch.clamp_min(rays[..., 2], 1e-6))[..., None]
            ok = valid & (z > DEPTH_MIN_M) & (z < DEPTH_MAX_M)
            pts_body = torch.where(ok[..., None], pts @ self._cam_to_body.T,
                                   0.0)
        f32 = torch.float32
        return torch.cat([xy.reshape(B, -1), desc.reshape(B, -1),
                          pts_body.reshape(B, -1), ok.to(f32),
                          valid.to(f32), gdesc], 1)


def yaw_rotate_np(yaw: float, pts: np.ndarray) -> np.ndarray:
    return turn_np(np.cos(yaw), np.sin(yaw), pts)


def turn_np(c, s, pts: np.ndarray) -> np.ndarray:
    """pts (..., 3) turned about z by the angle whose cosine and sine are
    c and s (scalars or arrays that broadcast against pts[..., 0])."""
    out = pts.copy()
    out[..., 0] = c * pts[..., 0] - s * pts[..., 1]
    out[..., 1] = s * pts[..., 0] + c * pts[..., 1]
    return out


class OmniLoopCam(LoopCam):
    """Omnidirectional (multi-direction) keyframe builder.

    Each direction's landmarks are rotated into the body frame at build
    time and merged into ONE KeyframeData per drone (the reference keeps a
    per-direction descriptor, loop_cam.cpp:178-229). ``view_yaws`` are each
    virtual pinhole direction's yaw relative to the body x-axis (default:
    front/left/back/right).
    """

    VIEW_YAWS = (0.0, np.pi / 2, np.pi, -np.pi / 2)

    def __init__(self, **kw):
        super().__init__(**kw)
        # cuDNN, not C1: the stereo batch's outputs leave the device in
        # f16, where C1's rounding difference from cuDNN's FFT path flips a
        # far landmark's f16 value by one spacing (0.20-0.22 px projected),
        # which the stereo cells' landmark_px limit of 0.2 px refuses; C1
        # takes these over once that limit admits one spacing (ROADMAP.md)
        self._kp.net.c1 = False

    def on_fisheye_frame(self, drone_id: int, frame_id: int, t: float,
                         vio_pose: np.ndarray,
                         stereo_pairs, view_yaws=None) -> KeyframeData:
        """stereo_pairs: sequence of (left, right) view pairs (up to 4
        directions; None entries skipped), extracted as one batch."""
        [kf] = self.on_fisheye_frames_batch(
            [(drone_id, frame_id, t, vio_pose, stereo_pairs)],
            view_yaws=view_yaws)
        return kf

    def on_fisheye_frames_batch(self, entries: Sequence[tuple],
                                view_yaws=None) -> list:
        """Extract many omnidirectional keyframes as one batch.

        entries: sequence of (drone_id, frame_id, t, vio_pose, stereo_pairs)
        tuples, e.g. every drone's keyframe of one step. All views of all
        entries go through the device as one batch, then split back into
        per-drone KeyframeData.
        """
        view_yaws = self.VIEW_YAWS if view_yaws is None else view_yaws
        with record_function("frontend/stage"):
            # an entry's views are the rows [start, end) of the batch
            lefts, rights, dirs, bounds = [], [], [], []
            for _d, _f, _t, _pose, stereo_pairs in entries:
                start = len(dirs)
                for v, pair in enumerate(stereo_pairs):
                    if pair is None:
                        continue
                    lefts.append(np.asarray(pair[0]))
                    rights.append(np.asarray(pair[1]))
                    dirs.append(v)
                bounds.append((start, len(dirs)))
            if not lefts:
                raise ValueError("no valid fisheye views")
            lefts, rights = np.stack(lefts), np.stack(rights)
        xy, desc, gdesc, pts_body, ok = self.extract_stereo_batch(lefts,
                                                                  rights)

        out = []
        with record_function("frontend/merge"):
            # a direction's cosine and sine from scalar calls, as
            # yaw_rotate_np takes them (np.cos of an array may round apart)
            cs = np.array([(np.cos(y), np.sin(y)) for y in view_yaws])[dirs]
            lms = turn_np(cs[:, :1], cs[:, 1:], pts_body)
            for e, ((drone_id, frame_id, t, vio_pose, _pairs), (a, b)) in \
                    enumerate(zip(entries, bounds)):
                if a == b:
                    raise ValueError(f"entry {e}: no valid fisheye views")
                gd = np.mean(list(gdesc[a:b]), axis=0)
                gd = gd / max(np.linalg.norm(gd), 1e-8)
                out.append(KeyframeData(
                    drone_id=drone_id, frame_id=frame_id, t=t,
                    pose=np.asarray(vio_pose, np.float32),
                    global_desc=gd.astype(np.float32),
                    kp_xy=xy[a:b].reshape(-1, 2),
                    landmarks_3d=lms[a:b].reshape(-1, 3),
                    local_desc=desc[a:b].reshape(-1, desc.shape[-1]),
                    valid=ok[a:b].reshape(-1)))
        return out
