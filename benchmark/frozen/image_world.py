"""Image-level synthetic world: textured walls rendered to stereo pairs;
the benchmark's frozen copy.

The wall textures are the port's ``sim/image_world.py`` (``_draw_line``,
``render_shapes``) copied unchanged in their arithmetic; the ray casting of
its ``RoomWorld`` and the step renderer of ``frontend_entry.py``
(``render_steps``) are written here again for the device, batched over
views, so that a change to the program cannot change the images the
benchmark feeds it, and the pool renders in a fraction of a second.

A pin-hole camera at a 4-DoF body pose (x, y, z, yaw) looks along body +x
(camera z forward); each pixel ray is intersected with the wall planes and
the nearest hit's texture is sampled bilinearly, in float64. Stereo pairs
shift the camera along body -y by the baseline.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# camera (x right, y down, z fwd) -> body (x fwd, y left, z up)
CAM_TO_BODY = np.array([[0.0, 0.0, 1.0],
                        [-1.0, 0.0, 0.0],
                        [0.0, -1.0, 0.0]])


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


class RoomWorld:
    """Four textured walls enclosing the flight volume (an indoor arena):
    vertical planes at x = +-half and y = +-half, each with its own random
    shape texture; a pixel shows the nearest wall its ray hits."""

    def __init__(self, half: float = 6.0, m_per_px: float = 0.04,
                 tex_h: int = 512, tex_w: int = 768, n_shapes: int = 150,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.m_per_px = m_per_px
        self.tex_h, self.tex_w = tex_h, tex_w
        h = half
        # (p0, inward normal n, in-plane e1); e2 is up
        self.specs = [
            ((h, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
            ((-h, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
            ((0.0, h, 0.0), (0.0, -1.0, 0.0), (-1.0, 0.0, 0.0)),
            ((0.0, -h, 0.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)),
        ]
        self.textures = np.stack([
            render_shapes(rng, tex_h, tex_w, n_shapes=n_shapes)[0]
            for _ in self.specs])

    def _sample(self, tex, u_m, v_m):
        """Bilinear sample of the flat texture ``tex`` at in-plane metres
        (u_m, v_m); 0.1 outside it."""
        u = self.tex_w / 2.0 - u_m / self.m_per_px
        v = self.tex_h / 2.0 - v_m / self.m_per_px
        inside = ((u >= 0) & (u < self.tex_w - 1)
                  & (v >= 0) & (v < self.tex_h - 1))
        u = u.clamp(0, self.tex_w - 2)
        v = v.clamp(0, self.tex_h - 2)
        u0, v0 = torch.floor(u), torch.floor(v)
        fu, fv = u - u0, v - v0
        at = (v0 * self.tex_w + u0).long()
        val = (tex[at] * (1 - fv) * (1 - fu)
               + tex[at + self.tex_w] * fv * (1 - fu)
               + tex[at + 1] * (1 - fv) * fu
               + tex[at + self.tex_w + 1] * fv * fu)
        return torch.where(inside, val, 0.1)

    def render(self, poses: torch.Tensor, fx: float, fy: float, h: int,
               w: int) -> torch.Tensor:
        """(V, h, w) float64 images of the camera poses (V, 4) float64."""
        dev = poses.device
        f64 = dict(dtype=torch.float64, device=dev)
        vs, us = torch.meshgrid(torch.arange(h, **f64),
                                torch.arange(w, **f64), indexing="ij")
        rays_cam = torch.stack([(us - w / 2) / fx, (vs - h / 2) / fy,
                                torch.ones_like(us)], -1)       # (h, w, 3)
        c, s = torch.cos(poses[:, 3]), torch.sin(poses[:, 3])
        z, o = torch.zeros_like(c), torch.ones_like(c)
        rz = torch.stack([torch.stack([c, -s, z], -1),
                          torch.stack([s, c, z], -1),
                          torch.stack([z, z, o], -1)], -2)      # (V, 3, 3)
        R = rz @ torch.tensor(CAM_TO_BODY, **f64)
        rays_w = torch.einsum("hwj,vij->vhwi", rays_cam, R)     # (V,h,w,3)
        pos = poses[:, None, None, :3]
        best_t = torch.full(rays_w.shape[:3], torch.inf, **f64)
        img = torch.full(rays_w.shape[:3], 0.05, **f64)
        tex_all = torch.tensor(self.textures, **f64).reshape(
            len(self.specs), -1)
        e2 = torch.tensor((0.0, 0.0, 1.0), **f64)
        for (p0, n, e1), tex in zip(self.specs, tex_all):
            p0, n, e1 = (torch.tensor(x, **f64) for x in (p0, n, e1))
            dn = rays_w @ n
            tparam = ((p0 - pos) @ n) / torch.where(dn.abs() < 1e-6, 1e-6,
                                                    dn)
            rel = pos + tparam[..., None] * rays_w - p0
            val = self._sample(tex, rel @ e1, rel @ e2)
            hit = (tparam > 0.05) & (tparam < best_t)
            best_t = torch.where(hit, tparam, best_t)
            img = torch.where(hit, val, img)
        return img


VIEW_YAWS = (0.0, np.pi / 2, np.pi, -np.pi / 2)   # front, left, back, right
CHUNK = 16                                          # views a render call


def _wrap(a):
    return a - 2 * np.pi * np.floor((a + np.pi) / (2 * np.pi))


def rig_poses(gt, frames, baseline: float) -> np.ndarray:
    """Camera poses (len(frames), D, 4 directions, 2 (left, right), 4) of
    every drone's rig at its ground-truth pose ``gt[frame, drone]``: each
    direction's yaw added to the body's, the right camera at body (0,
    -baseline, 0) of that direction's frame."""
    body = np.asarray(gt, np.float64)[list(frames)]           # (S, D, 4)
    yaw = _wrap(body[..., None, 3] + np.asarray(VIEW_YAWS))   # (S, D, 4)
    left = np.concatenate([np.broadcast_to(
        body[..., None, :3], yaw.shape + (3,)), yaw[..., None]], -1)
    right = left.copy()
    right[..., 0] += baseline * np.sin(yaw)
    right[..., 1] -= baseline * np.cos(yaw)
    return np.stack([left, right], -2)


def render_steps(gt, frames, fx: float, fy: float, h: int, w: int,
                 baseline: float, world: RoomWorld, seed: int, device):
    """Per frame in ``frames``: every drone's 4 directions' (left, right)
    uint8 views, as nested lists of numpy arrays. The views render on
    ``device`` CHUNK at a time (32 MB a float64 ray tensor at 208 x 400),
    each with N(0, 0.01) pixel noise drawn from one ``torch.Generator``
    seeded with ``seed``."""
    poses = torch.tensor(rig_poses(gt, frames, baseline), device=device)
    shape = poses.shape[:-1]
    flat = poses.reshape(-1, 4)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    out = torch.empty((flat.shape[0], h, w), dtype=torch.uint8,
                      device=device)
    for i in range(0, flat.shape[0], CHUNK):
        img = world.render(flat[i:i + CHUNK], fx, fy, h, w)
        img = img + 0.01 * torch.randn(img.shape, generator=gen,
                                       dtype=torch.float64, device=device)
        out[i:i + CHUNK] = (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    views = out.reshape(shape + (h, w)).cpu().numpy()
    return [[[(views[k, d, v, 0], views[k, d, v, 1]) for v in range(4)]
             for d in range(shape[1])] for k in range(shape[0])]
