"""Synthetic visual world: persistent 3-D landmarks with stable descriptors.

A copy of ``omniswarm_tpu/sim/visual_world.py`` (numpy), the feature-level
world of the decentralized demo: a bank of world landmarks carries
persistent random descriptors, a keyframe sees the landmarks within range of
its pose, and its global descriptor is a smooth positional encoding, so
retrieval, descriptor matching and PnP all run their real code on
consistent geometry. One ``np.random.default_rng(seed)`` makes the world and
then the descriptor noise of every keyframe, in call order.
"""
from __future__ import annotations

import numpy as np

from omniswarm_torch.swarm.comm import KeyframeData


class VisualWorld:
    def __init__(self, seed: int = 0, n_landmarks: int = 400,
                 extent: float = 12.0, desc_dim: int = 64,
                 global_dim: int = 256):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.pts = rng.uniform(-extent, extent, size=(n_landmarks, 3))
        self.pts[:, 2] = rng.uniform(0, 5, size=n_landmarks)
        self.desc = rng.normal(size=(n_landmarks, desc_dim)).astype(np.float32)
        self.desc /= np.linalg.norm(self.desc, axis=1, keepdims=True)
        self.gproj = rng.normal(size=(3, global_dim)).astype(np.float32)
        self.desc_dim = desc_dim
        self.global_dim = 2 * global_dim

    def global_desc(self, pose: np.ndarray) -> np.ndarray:
        z = np.concatenate([
            np.sin(self.gproj.T @ (pose[:3] * 0.3)),
            np.cos(self.gproj.T @ (pose[:3] * 0.3))])
        return (z / np.linalg.norm(z)).astype(np.float32)

    def make_keyframe(self, drone: int, frame: int, gt_pose: np.ndarray,
                      t: float, *, vio_pose: np.ndarray | None = None,
                      max_pts: int = 60, desc_noise: float = 0.02,
                      min_range: float = 0.5, max_range: float = 8.0
                      ) -> KeyframeData:
        """Observe the world from gt_pose; metadata carries vio_pose.

        Landmark geometry uses ground truth (the camera sees the real
        world); the ``pose`` field is the drone's *believed* (VIO) pose —
        what downstream anchoring must use, exactly as on hardware.
        """
        gt_pose = np.asarray(gt_pose, float)
        c, s = np.cos(-gt_pose[3]), np.sin(-gt_pose[3])
        d = self.pts - gt_pose[:3]
        body = np.stack([c * d[:, 0] - s * d[:, 1],
                         s * d[:, 0] + c * d[:, 1], d[:, 2]], 1)
        dist = np.linalg.norm(body, axis=1)
        vis = np.flatnonzero((dist > min_range) & (dist < max_range))[:max_pts]
        K = max_pts
        p3d = np.zeros((K, 3), np.float32)
        desc = np.zeros((K, self.desc_dim), np.float32)
        valid = np.zeros(K, bool)
        p3d[:len(vis)] = body[vis]
        dn = self.desc[vis] + self.rng.normal(
            0, desc_noise, size=(len(vis), self.desc_dim)).astype(np.float32)
        desc[:len(vis)] = dn / np.linalg.norm(dn, axis=1, keepdims=True)
        valid[:len(vis)] = True
        pose_meta = gt_pose if vio_pose is None else np.asarray(vio_pose)
        return KeyframeData(
            drone_id=drone, frame_id=frame, t=t,
            pose=pose_meta.astype(np.float32),
            global_desc=self.global_desc(gt_pose),
            kp_xy=np.zeros((K, 2), np.float32),
            landmarks_3d=p3d, local_desc=desc, valid=valid)
