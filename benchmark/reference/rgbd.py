"""Plain reference of an RGB-D keyframe step: the upstream PINHOLE_DEPTH
keyframe (``generate_gray_depth_image_descriptor``, loop_cam.cpp:231-339)
of every drone's pinhole view with its registered depth map.

For a batch of views: SuperPoint keypoints with PCA descriptors and the
MobileNetVLAD v2 global descriptor, as ``reference.frontend`` computes
them; then each keypoint's depth read from its view's depth map at the
keypoint's pixel rounded to the nearest (half to even), the keypoint
lifted along its pinhole ray to that depth, z * ((x - cx) / fx, (y - cy) /
fy, 1), kept where the depth lies in (0.3, 10) m, and turned from the
camera frame (x right, y down, z forward) into the body frame (x forward,
y left, z up). A depth of 0 is a hole and fails the gate. Every layer is
plain ``torch`` in float32, in whatever matrix-product and convolution
precision is in force (the judge turns TF32 off; the control turns it on).

Departures from loop_cam.cpp:231-339:

- the CNNs are the bundled PyTorch-layout checkpoints (SuperPoint with
  its fitted PCA, MobileNetVLAD v2), run in float32; the upstream runs
  TensorRT engines;
- the camera is the forward-looking ``CAM_TO_BODY`` rotation with no
  translation, not a calibrated extrinsic; landmarks stay in the body
  frame, with the keyframe's pose carried beside them;
- every keypoint keeps its slot (a fixed K a view) with a validity flag,
  the port's fixed shapes;
- the outputs stay float32: the program hands out this path's keyframes
  unrounded.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import frontend as ref

DEPTH_MIN_M, DEPTH_MAX_M = 0.3, 10.0


class RgbdOut(NamedTuple):
    """Per view (B = drones): keypoints, descriptors, global descriptors,
    body-frame landmarks (0 where not lifted), their validity, the
    keypoints' validity, and the reference's ranked candidate scores and
    heat maps, which judge another's keypoints; float32 numpy."""
    xy: np.ndarray          # (B, K, 2)
    desc: np.ndarray        # (B, K, C)
    gdesc: np.ndarray       # (B, G)
    pts: np.ndarray         # (B, K, 3)
    ok: np.ndarray          # (B, K) bool
    kp_valid: np.ndarray    # (B, K) bool
    ranked: np.ndarray      # (B, K + 1)
    heat: np.ndarray        # (B, H, W)


def depth_at(depths: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, K) depths of (B, H, W) maps at the pixels nearest xy (B, K, 2),
    halves rounded to even, clamped into the map."""
    B, H, W = depths.shape
    xi = torch.clamp(torch.round(xy[..., 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).long(), 0, H - 1)
    b = torch.arange(B, device=depths.device)[:, None]
    return depths[b, yi, xi]


def lift(xy: torch.Tensor, z: torch.Tensor, fp: dict):
    """(camera-frame points (B, K, 3), gate (B, K)): each pixel lifted to
    depth z along its pinhole ray; the gate keeps depths in (0.3, 10) m."""
    pts = torch.stack([(xy[..., 0] - fp["cx"]) / fp["fx"] * z,
                       (xy[..., 1] - fp["cy"]) / fp["fy"] * z, z], -1)
    return pts, (z > DEPTH_MIN_M) & (z < DEPTH_MAX_M)


@torch.no_grad()
def step(sp, nv, fp: dict, grays: np.ndarray, depths: np.ndarray,
         device, depth_scale: float = 1e-3) -> RgbdOut:
    """The reference's RGB-D batch on (B, H, W) uint8 views and their
    (B, H, W) uint16 depth maps in units of ``depth_scale`` metres."""
    imgs = torch.tensor(grays, device=device)[:, None].float() / 255.0
    z_map = torch.tensor(depths.astype(np.int32), device=device).float() \
        * depth_scale
    heat, dmap = ref.superpoint(sp, imgs)
    K, r, thr = fp["max_keypoints"], fp["nms_dist"], fp["superpoint_thres"]
    xy, _scores, valid, ranked = ref.keypoints(heat, K, r, thr)
    desc = ref.sample_descriptors(dmap, xy, sp["pca_components"],
                                  sp["pca_mean"])
    gdesc = ref.netvlad(nv, imgs)
    pts, gate = lift(xy, depth_at(z_map, xy), fp)
    ok = valid & gate
    body = torch.where(ok[..., None], pts @ torch.tensor(
        ref.CAM_TO_BODY, device=device).T, 0.0)
    host = lambda t: t.cpu().numpy()
    return RgbdOut(host(xy), host(desc), host(gdesc), host(body), host(ok),
                   host(valid), host(ranked), host(heat))
