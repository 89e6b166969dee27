"""Image-level synthetic world: textured walls rendered to stereo pairs.

Numpy copies of ``omniswarm_tpu/sim/image_world.py`` (:27-226: ``_rotz``,
``WallWorld``, ``RoomWorld``) and of the shape renderer they texture their
walls with (``omniswarm_tpu/models/train_superpoint.py`` :31-79:
``_draw_line``, ``render_shapes``), so that the port renders without the JAX
package. The same seed and the same ``numpy.random.Generator`` state give
bit-identical images in both packages (tests/test_torch_frontend_ops.py).

A pin-hole camera at a 4-DoF body pose (x, y, z, yaw) looks along body +x
(camera z forward); each pixel ray is intersected with the wall planes and
the nearest hit's texture is sampled bilinearly. Stereo pairs shift the
camera along body -y by the baseline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from omniswarm_torch.swarm.loop_cam import CAM_TO_BODY


# ---------------------------------------------------------------------------
# Synthetic shape rendering (wall textures)
# ---------------------------------------------------------------------------

def _draw_line(img, p0, p1, val):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    ts = np.linspace(0, 1, n)
    xs = np.clip(np.round(p0[0] + ts * (p1[0] - p0[0])).astype(int), 0,
                 img.shape[1] - 1)
    ys = np.clip(np.round(p0[1] + ts * (p1[1] - p0[1])).astype(int), 0,
                 img.shape[0] - 1)
    img[ys, xs] = val
    return img


def render_shapes(rng: np.random.Generator, h: int, w: int,
                  n_shapes: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (image (h, w) in [0,1], corners (K, 2) [x, y])."""
    img = np.full((h, w), rng.uniform(0.0, 0.3), np.float32)
    corners = []
    for _ in range(n_shapes):
        kind = rng.integers(0, 3)
        val = rng.uniform(0.5, 1.0)
        if kind == 0:       # polygon (tri/quad)
            nv = rng.integers(3, 5)
            cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
            r = rng.uniform(5, min(h, w) / 3)
            angs = np.sort(rng.uniform(0, 2 * np.pi, nv))
            pts = np.stack([cx + r * np.cos(angs), cy + r * np.sin(angs)], 1)
            pts[:, 0] = np.clip(pts[:, 0], 1, w - 2)
            pts[:, 1] = np.clip(pts[:, 1], 1, h - 2)
            for i in range(nv):
                img = _draw_line(img, pts[i], pts[(i + 1) % nv], val)
            corners.extend(pts)
        elif kind == 1:     # line segment (endpoints are corners)
            p0 = np.array([rng.uniform(1, w - 2), rng.uniform(1, h - 2)])
            p1 = np.array([rng.uniform(1, w - 2), rng.uniform(1, h - 2)])
            img = _draw_line(img, p0, p1, val)
            corners.extend([p0, p1])
        else:               # ellipse outline (no corners)
            cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
            a, b = rng.uniform(4, 15, 2)
            ts = np.linspace(0, 2 * np.pi, 80)
            xs = np.clip(np.round(cx + a * np.cos(ts)).astype(int), 0, w - 1)
            ys = np.clip(np.round(cy + b * np.sin(ts)).astype(int), 0, h - 1)
            img[ys, xs] = val
    img += rng.normal(0, 0.03, size=img.shape).astype(np.float32)
    img = np.clip(img, 0, 1)
    if corners:
        c = np.asarray(corners, np.float32)
    else:
        c = np.zeros((0, 2), np.float32)
    return img, c


def _rotz(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@dataclass
class WallWorld:
    """Textured wall at world x = wall_x spanning y (right) and z (up)."""

    wall_x: float = 3.0
    tilt: float = 0.45
    m_per_px: float = 0.04
    tex_h: int = 512
    tex_w: int = 768
    n_shapes: int = 150
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.texture, _ = render_shapes(rng, self.tex_h, self.tex_w,
                                        n_shapes=self.n_shapes)
        # plane through (wall_x, 0, 0); ``tilt`` yaws its normal away from
        # -x so scene depth varies across the image (a fronto-parallel
        # plane leaves PnP's yaw/lateral-translation pair near-degenerate)
        c, s = np.cos(self.tilt), np.sin(self.tilt)
        self.plane_p0 = np.array([self.wall_x, 0.0, 0.0])
        self.plane_n = np.array([c, s, 0.0])       # pointing toward +x side
        self.plane_e1 = np.array([-s, c, 0.0])     # in-plane horizontal
        self.plane_e2 = np.array([0.0, 0.0, 1.0])  # in-plane vertical

    def plane_distance(self, pts_w: np.ndarray) -> np.ndarray:
        """Signed distance of world points to the wall plane."""
        return (np.asarray(pts_w) - self.plane_p0) @ self.plane_n

    def _sample_texture(self, y_w: np.ndarray, z_w: np.ndarray) -> np.ndarray:
        """In-plane wall coords → bilinear texture sample (background 0.1)."""
        # texture centered: u along -e1, v along -e2
        u = self.tex_w / 2.0 - y_w / self.m_per_px
        v = self.tex_h / 2.0 - z_w / self.m_per_px
        inside = (u >= 0) & (u < self.tex_w - 1) & (v >= 0) & (v < self.tex_h - 1)
        u = np.clip(u, 0, self.tex_w - 2)
        v = np.clip(v, 0, self.tex_h - 2)
        u0 = np.floor(u).astype(int)
        v0 = np.floor(v).astype(int)
        fu, fv = u - u0, v - v0
        t = self.texture
        val = (t[v0, u0] * (1 - fv) * (1 - fu)
               + t[v0 + 1, u0] * fv * (1 - fu)
               + t[v0, u0 + 1] * (1 - fv) * fu
               + t[v0 + 1, u0 + 1] * fv * fu)
        return np.where(inside, val, 0.1).astype(np.float32)

    def render(self, pose: np.ndarray, intr, h: int, w: int, *,
               noise: float = 0.01,
               rng: np.random.Generator | None = None) -> np.ndarray:
        """Render (h, w) grayscale from a 4-DoF body pose.

        ``intr`` is either the simple pinhole CameraIntrinsics or any
        ops.camera model exposing ``lift`` (MEI / Kannala-Brandt fisheye,
        distorted pinhole): each pixel's ray comes from the camera model,
        so rendered images carry the model's true distortion.
        """
        pose = np.asarray(pose, float)
        us, vs = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        if hasattr(intr, "lift"):
            uv = np.stack([us, vs], -1).reshape(-1, 2)
            rays_cam = np.asarray(intr.lift(uv), np.float32).reshape(h, w, 3)
            # normalize to z=1-style scaling not needed: plane intersection
            # below works with any ray scale
        else:
            rays_cam = np.stack([(us - intr.cx) / intr.fx,
                                 (vs - intr.cy) / intr.fy,
                                 np.ones_like(us)], -1)      # (h, w, 3)
        R = _rotz(pose[3]) @ CAM_TO_BODY
        rays_w = rays_cam @ R.T                              # (h, w, 3)
        dn = rays_w @ self.plane_n
        tparam = ((self.plane_p0 - pose[:3]) @ self.plane_n) / np.where(
            np.abs(dn) < 1e-6, 1e-6, dn)
        X = pose[:3] + tparam[..., None] * rays_w            # (h, w, 3)
        rel = X - self.plane_p0
        img = self._sample_texture(rel @ self.plane_e1, rel @ self.plane_e2)
        img = np.where(tparam > 0, img, 0.0)
        if noise and rng is not None:
            img = np.clip(img + rng.normal(0, noise, img.shape), 0, 1)
        return img.astype(np.float32)

    def render_stereo(self, pose: np.ndarray, intr,
                      h: int, w: int, baseline: float, *,
                      noise: float = 0.01,
                      rng: np.random.Generator | None = None):
        """(left, right): right camera shifted by +baseline along camera x.

        Camera x is body -y, so the right camera sits at
        body (0, -baseline, 0) — matching LoopCam's triangulation
        convention.
        """
        pose = np.asarray(pose, float)
        left = self.render(pose, intr, h, w, noise=noise, rng=rng)
        off_w = _rotz(pose[3]) @ np.array([0.0, -baseline, 0.0])
        pose_r = pose.copy()
        pose_r[:3] += off_w
        right = self.render(pose_r, intr, h, w, noise=noise, rng=rng)
        return left, right


class RoomWorld:
    """Four textured walls enclosing the flight volume (an indoor arena).

    Each wall is a vertical plane at x = +-half / y = +-half with its own
    random shape texture; rendering intersects every pixel ray with all
    four planes and samples the nearest one hit. Gives every pose and every
    viewing direction visual structure, so omnidirectional keyframes close
    loops from anywhere inside — the image-level analog of the reference's
    indoor flight arenas.
    """

    def __init__(self, half: float = 6.0, m_per_px: float = 0.04,
                 tex_h: int = 512, tex_w: int = 768, n_shapes: int = 150,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.half = half
        self.m_per_px = m_per_px
        self.tex_h, self.tex_w = tex_h, tex_w
        self.planes = []
        h = half
        # (p0, inward normal n, in-plane e1, e2=up, texture)
        specs = [
            (np.array([h, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0]),
             np.array([0.0, 1.0, 0.0])),
            (np.array([-h, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]),
             np.array([0.0, -1.0, 0.0])),
            (np.array([0.0, h, 0.0]), np.array([0.0, -1.0, 0.0]),
             np.array([-1.0, 0.0, 0.0])),
            (np.array([0.0, -h, 0.0]), np.array([0.0, 1.0, 0.0]),
             np.array([1.0, 0.0, 0.0])),
        ]
        e2 = np.array([0.0, 0.0, 1.0])
        for p0, n, e1 in specs:
            tex, _ = render_shapes(rng, tex_h, tex_w, n_shapes=n_shapes)
            self.planes.append((p0, n, e1, e2, tex))

    def _sample(self, tex, u_m, v_m):
        u = self.tex_w / 2.0 - u_m / self.m_per_px
        v = self.tex_h / 2.0 - v_m / self.m_per_px
        inside = ((u >= 0) & (u < self.tex_w - 1)
                  & (v >= 0) & (v < self.tex_h - 1))
        u = np.clip(u, 0, self.tex_w - 2)
        v = np.clip(v, 0, self.tex_h - 2)
        u0 = np.floor(u).astype(int)
        v0 = np.floor(v).astype(int)
        fu, fv = u - u0, v - v0
        val = (tex[v0, u0] * (1 - fv) * (1 - fu)
               + tex[v0 + 1, u0] * fv * (1 - fu)
               + tex[v0, u0 + 1] * (1 - fv) * fu
               + tex[v0 + 1, u0 + 1] * fv * fu)
        return np.where(inside, val, 0.1).astype(np.float32)

    def render(self, pose: np.ndarray, intr, h: int, w: int, *,
               noise: float = 0.01,
               rng: np.random.Generator | None = None) -> np.ndarray:
        pose = np.asarray(pose, float)
        us, vs = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        if hasattr(intr, "lift"):
            uv = np.stack([us, vs], -1).reshape(-1, 2)
            rays_cam = np.asarray(intr.lift(uv), np.float32).reshape(h, w, 3)
        else:
            rays_cam = np.stack([(us - intr.cx) / intr.fx,
                                 (vs - intr.cy) / intr.fy,
                                 np.ones_like(us)], -1)
        R = _rotz(pose[3]) @ CAM_TO_BODY
        rays_w = rays_cam @ R.T
        best_t = np.full((h, w), np.inf, np.float32)
        img = np.full((h, w), 0.05, np.float32)
        for p0, n, e1, e2, tex in self.planes:
            dn = rays_w @ n
            tparam = ((p0 - pose[:3]) @ n) / np.where(
                np.abs(dn) < 1e-6, 1e-6, dn)
            X = pose[:3] + tparam[..., None] * rays_w
            rel = X - p0
            val = self._sample(tex, rel @ e1, rel @ e2)
            hit = (tparam > 0.05) & (tparam < best_t)
            best_t = np.where(hit, tparam, best_t)
            img = np.where(hit, val, img)
        if noise and rng is not None:
            img = np.clip(img + rng.normal(0, noise, img.shape), 0, 1)
        return img.astype(np.float32)

    def render_stereo(self, pose: np.ndarray, intr, h: int, w: int,
                      baseline: float, *, noise: float = 0.01,
                      rng: np.random.Generator | None = None):
        """(left, right) with the right camera at body (0, -baseline, 0)."""
        pose = np.asarray(pose, float)
        left = self.render(pose, intr, h, w, noise=noise, rng=rng)
        off_w = _rotz(pose[3]) @ np.array([0.0, -baseline, 0.0])
        pose_r = pose.copy()
        pose_r[:3] += off_w
        right = self.render(pose_r, intr, h, w, noise=noise, rng=rng)
        return left, right
