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
before they leave the device, so the two packages hand out the same values.
Left out of the reference's LoopCam: the per-pair ``_extract_batch_fallback``
(for injected test extractors) and the batch padding to multiples of 4
(for XLA's compile cache); neither changes an output row of this path.
Intrinsics that carry a generic camera model (``ops.camera.CameraBearings``
around a pinhole, MEI or Kannala-Brandt model, the reference's :125-134)
lift the keypoints with that model's ``lift`` in the fused extraction.

Besides the device stages' ``torch.profiler`` ranges (``frontend/netvlad``,
``frontend/matching``, ``frontend/triangulation``), a batch's host phases
carry ranges: ``frontend/stage`` (gathering, stacking and concatenating the
views), ``frontend/upload`` (the views' copy to the device),
``frontend/download`` (the outputs' copies to the host) and
``frontend/merge`` (the host casts and the per-drone merge). Stage and
merge hold host numpy only, no torch op, so a profile's idle device gaps
inside them carry their names.
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


class LoopCam:
    """Stereo and RGB-D keyframe builder on one device (default the GPU).

    ``last_kp_valid`` holds the (B, K) validity of the left views' SuperPoint
    keypoints of the last ``extract_stereo_batch`` call (a KeyframeData's
    ``valid`` marks triangulated landmarks, a subset).
    """

    def __init__(self, *, params: Optional[FrontendParams] = None,
                 intrinsics: Optional[CameraIntrinsics] = None,
                 baseline: float = 0.12, device="cuda"):
        from omniswarm_torch.models.netvlad import (
            BUNDLED_OUT_DIM, pretrained_global_extractor)
        from omniswarm_torch.models.superpoint import pretrained_extractor

        self.p = params or FrontendParams()
        self.intr = intrinsics or CameraIntrinsics(
            fx=0.5 * self.p.width, fy=0.5 * self.p.width,
            cx=self.p.width / 2, cy=self.p.height / 2)
        self.baseline = baseline
        self.device = resolve_device(device)
        if self.p.global_desc_dim != BUNDLED_OUT_DIM:
            raise ValueError(
                f"global_desc_dim {self.p.global_desc_dim}: the bundled "
                f"NetVLAD checkpoint gives {BUNDLED_OUT_DIM}")
        self._kp = pretrained_extractor(
            self.device, max_keypoints=self.p.max_keypoints,
            threshold=self.p.superpoint_thres, nms_dist=self.p.nms_dist,
            pca_dim=self.p.local_desc_dim)
        self._gd = pretrained_global_extractor(self.device)
        self._cam_to_body = torch.tensor(CAM_TO_BODY, dtype=torch.float32,
                                         device=self.device)
        self.last_kp_valid: Optional[np.ndarray] = None

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

    def extract_stereo_batch(self, lefts: np.ndarray, rights: np.ndarray):
        """Run the front-end on B stereo pairs.

        lefts/rights: (B, H, W) grayscale, uint8 or in [0, 1]. Returns numpy
        (kp_xy (B,K,2), local_desc (B,K,C), global_desc (B,G),
        landmarks_body (B,K,3), valid (B,K)).
        """
        with highp():
            out = self._extract_device(np.asarray(lefts), np.asarray(rights))
        with record_function("frontend/download"):
            xy, desc, gdesc, pts_body, ok, kp_valid = (t.cpu().numpy()
                                                       for t in out)
        with record_function("frontend/merge"):
            self.last_kp_valid = kp_valid
            gdesc = gdesc.astype(np.float32)
            gdesc = gdesc / np.maximum(
                np.linalg.norm(gdesc, axis=-1, keepdims=True), 1e-8)
            return (xy.astype(np.float32), desc.astype(np.float32),
                    gdesc, pts_body.astype(np.float32), ok.astype(bool))

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

    @torch.no_grad()
    def on_depth_frame(self, drone_id: int, frame_id: int, t: float,
                       vio_pose: np.ndarray, gray: np.ndarray,
                       depth: np.ndarray) -> KeyframeData:
        """RGB-D keyframe: back-project keypoints through the depth map
        (reference PINHOLE_DEPTH path, loop_cam.cpp:231-339)."""
        img = torch.as_tensor(np.asarray(gray, np.float32),
                              device=self.device)[None, None]
        with highp():
            xy, _scores, desc, valid = self._kp(img)
            gdesc = self._gd(img)[0].cpu().numpy()
        xy0 = xy[0].cpu().numpy()
        xi = np.clip(np.round(xy0[:, 0]).astype(int), 0, depth.shape[1] - 1)
        yi = np.clip(np.round(xy0[:, 1]).astype(int), 0, depth.shape[0] - 1)
        z = depth[yi, xi]
        rays = self.intr.bearings(xy0.astype(np.float32))
        pts_cam = rays * (z / np.maximum(rays[:, 2], 1e-6))[:, None]
        ok = valid[0].cpu().numpy() & (z > 0.3) & (z < 10.0)
        pts_body = pts_cam @ CAM_TO_BODY.T
        return KeyframeData(
            drone_id=drone_id, frame_id=frame_id, t=t,
            pose=np.asarray(vio_pose, np.float32),
            global_desc=gdesc.astype(np.float32),
            kp_xy=xy0.astype(np.float32),
            landmarks_3d=np.where(ok[:, None], pts_body, 0.0).astype(
                np.float32),
            local_desc=desc[0].cpu().numpy().astype(np.float32),
            valid=ok)


def yaw_rotate_np(yaw: float, pts: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    out = pts.copy()
    out[:, 0] = c * pts[:, 0] - s * pts[:, 1]
    out[:, 1] = s * pts[:, 0] + c * pts[:, 1]
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
            lefts, rights, owners = [], [], []
            for e, (_d, _f, _t, _pose, stereo_pairs) in enumerate(entries):
                for v, pair in enumerate(stereo_pairs):
                    if pair is None:
                        continue
                    lefts.append(np.asarray(pair[0]))
                    rights.append(np.asarray(pair[1]))
                    owners.append((e, v))
            if not lefts:
                raise ValueError("no valid fisheye views")
            lefts, rights = np.stack(lefts), np.stack(rights)
        xy, desc, gdesc, pts_body, ok = self.extract_stereo_batch(lefts,
                                                                  rights)

        out = []
        with record_function("frontend/merge"):
            for e, (drone_id, frame_id, t, vio_pose, _pairs) in \
                    enumerate(entries):
                rows = [i for i, (eo, _v) in enumerate(owners) if eo == e]
                if not rows:
                    raise ValueError(f"entry {e}: no valid fisheye views")
                kp_xy = np.concatenate([xy[i] for i in rows], 0)
                lms = np.concatenate(
                    [yaw_rotate_np(view_yaws[owners[i][1]], pts_body[i])
                     for i in rows], 0)
                descs = np.concatenate([desc[i] for i in rows], 0)
                valid = np.concatenate([ok[i] for i in rows], 0)
                gd = np.mean([gdesc[i] for i in rows], axis=0)
                gd = gd / max(np.linalg.norm(gd), 1e-8)
                out.append(KeyframeData(
                    drone_id=drone_id, frame_id=frame_id, t=t,
                    pose=np.asarray(vio_pose, np.float32),
                    global_desc=gd.astype(np.float32), kp_xy=kp_xy,
                    landmarks_3d=lms.astype(np.float32), local_desc=descs,
                    valid=valid))
        return out
