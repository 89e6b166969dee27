"""Camera models: pinhole+radtan, MEI (unified omni), Kannala-Brandt fisheye.

Counterpart of ``omniswarm_tpu/ops/camera.py`` (the camodocal models the
reference loads per rig direction). Everything is batched torch with static
iteration counts (the radtan and Kannala-Brandt inversions take 8 steps
each, as the reference's), so ``lift`` runs on whatever device its input
lies on, inside the front-end's fused extraction.

Conventions: camera frame x right, y down, z forward; pixels (u, v);
``lift`` returns unit rays, ``project`` returns pixels plus a validity mask
(point in front / inside the model's domain). A numpy input is taken as a
float32 tensor on the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _distort_radtan(mx, my, k1, k2, p1, p2):
    r2 = mx * mx + my * my
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * mx * my + p2 * (r2 + 2.0 * mx * mx)
    dy = p1 * (r2 + 2.0 * my * my) + 2.0 * p2 * mx * my
    return mx * rad + dx, my * rad + dy


def _undistort_radtan(ux, uy, k1, k2, p1, p2, iters: int = 8):
    """Fixed-point inversion of the radtan map (the OpenCV recursion)."""
    mx, my = ux, uy
    for _ in range(iters):
        r2 = mx * mx + my * my
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * mx * my + p2 * (r2 + 2.0 * mx * mx)
        dy = p1 * (r2 + 2.0 * my * my) + 2.0 * p2 * mx * my
        mx = (ux - dx) / rad
        my = (uy - dy) / rad
    return mx, my


@dataclass(frozen=True)
class PinholeCamera:
    """Pinhole + radial-tangential distortion (camodocal PINHOLE)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def project(self, p3) -> Tuple[torch.Tensor, torch.Tensor]:
        p3 = _tensor(p3)
        z = torch.clamp(p3[..., 2], min=1e-9)
        mx, my = p3[..., 0] / z, p3[..., 1] / z
        dx, dy = _distort_radtan(mx, my, self.k1, self.k2, self.p1, self.p2)
        uv = torch.stack([self.fx * dx + self.cx, self.fy * dy + self.cy],
                         -1)
        return uv, p3[..., 2] > 1e-9

    def lift(self, uv) -> torch.Tensor:
        uv = _tensor(uv)
        ux = (uv[..., 0] - self.cx) / self.fx
        uy = (uv[..., 1] - self.cy) / self.fy
        mx, my = _undistort_radtan(ux, uy, self.k1, self.k2, self.p1,
                                   self.p2)
        return _unit(torch.stack([mx, my, torch.ones_like(mx)], -1))


@dataclass(frozen=True)
class MeiCamera:
    """MEI / unified omnidirectional model (camodocal MEI).

    Projection: unit-sphere point s = p/|p|, projective division by
    (s_z + xi), radtan distortion, then K. Lift uses the closed-form sphere
    reprojection (camodocal CataCamera::liftProjective).
    """

    xi: float
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def project(self, p3) -> Tuple[torch.Tensor, torch.Tensor]:
        s = _unit(_tensor(p3))
        den = s[..., 2] + self.xi
        valid = den > 1e-6
        den = torch.where(valid, den, 1.0)
        mx, my = s[..., 0] / den, s[..., 1] / den
        dx, dy = _distort_radtan(mx, my, self.k1, self.k2, self.p1, self.p2)
        uv = torch.stack([self.fx * dx + self.cx, self.fy * dy + self.cy],
                         -1)
        return uv, valid

    def lift(self, uv) -> torch.Tensor:
        uv = _tensor(uv)
        ux = (uv[..., 0] - self.cx) / self.fx
        uy = (uv[..., 1] - self.cy) / self.fy
        mx, my = _undistort_radtan(ux, uy, self.k1, self.k2, self.p1,
                                   self.p2)
        r2 = mx * mx + my * my
        xi = self.xi
        # the factor maps the undistorted projective point back to the
        # unit sphere
        factor = (xi + torch.sqrt(torch.clamp(
            1.0 + (1.0 - xi * xi) * r2, min=0.0))) / (1.0 + r2)
        ray = torch.stack([factor * mx, factor * my, factor - xi], -1)
        return _unit(ray)


@dataclass(frozen=True)
class EquidistantCamera:
    """Kannala-Brandt fisheye (camodocal KANNALA_BRANDT / EQUIDISTANT).

    r_d(theta) = theta + k2 th^3 + k3 th^5 + k4 th^7 + k5 th^9 (camodocal's
    naming: mu/mv focal, k2..k5 odd-polynomial).
    """

    mu: float
    mv: float
    u0: float
    v0: float
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0

    def _theta_poly(self, th):
        th2 = th * th
        return th * (1.0 + th2 * (self.k2 + th2 * (
            self.k3 + th2 * (self.k4 + th2 * self.k5))))

    def project(self, p3) -> Tuple[torch.Tensor, torch.Tensor]:
        p3 = _tensor(p3)
        r = torch.sqrt(p3[..., 0] ** 2 + p3[..., 1] ** 2)
        theta = torch.atan2(r, p3[..., 2])
        scale = self._theta_poly(theta) / torch.clamp(r, min=1e-12)
        uv = torch.stack([self.mu * scale * p3[..., 0] + self.u0,
                          self.mv * scale * p3[..., 1] + self.v0], -1)
        # the odd polynomial is monotone only within the calibrated FOV
        return uv, theta < math.pi * 0.95

    def lift(self, uv, iters: int = 8) -> torch.Tensor:
        uv = _tensor(uv)
        px = (uv[..., 0] - self.u0) / self.mu
        py = (uv[..., 1] - self.v0) / self.mv
        rd = torch.sqrt(px * px + py * py)
        # invert rd = poly(theta) by Newton with a static trip count
        theta = rd
        for _ in range(iters):
            th2 = theta * theta
            f = self._theta_poly(theta) - rd
            fp = 1.0 + th2 * (3.0 * self.k2 + th2 * (
                5.0 * self.k3 + th2 * (7.0 * self.k4
                                       + th2 * 9.0 * self.k5)))
            theta = theta - f / torch.clamp(fp, min=1e-6)
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        inv_rd = 1.0 / torch.clamp(rd, min=1e-12)
        ray = torch.stack([sin_t * px * inv_rd, sin_t * py * inv_rd, cos_t],
                          -1)
        # at the optical centre the ray is straight ahead
        fwd = torch.tensor([0.0, 0.0, 1.0], dtype=ray.dtype,
                           device=ray.device).expand_as(ray)
        return _unit(torch.where(rd[..., None] < 1e-9, fwd, ray))


def camera_from_yaml(path_or_dict) -> object:
    """A camera from a camodocal-style YAML (model_type + parameter maps):
    ``model_type`` PINHOLE / MEI / KANNALA_BRANDT, ``distortion_parameters``
    {k1 k2 p1 p2} or {k2..k5}, ``projection_parameters`` {fx fy cx cy} /
    {gamma1 gamma2 u0 v0} / {mu mv u0 v0}, and ``mirror_parameters`` {xi}
    for MEI."""
    if isinstance(path_or_dict, dict):
        cfg = path_or_dict
    else:
        import yaml

        with open(path_or_dict) as f:
            cfg = yaml.safe_load(f)
    mt = str(cfg.get("model_type", "PINHOLE")).upper()
    d = cfg.get("distortion_parameters", {}) or {}
    p = cfg.get("projection_parameters", {}) or {}
    if mt == "PINHOLE":
        return PinholeCamera(
            fx=float(p["fx"]), fy=float(p["fy"]),
            cx=float(p["cx"]), cy=float(p["cy"]),
            k1=float(d.get("k1", 0)), k2=float(d.get("k2", 0)),
            p1=float(d.get("p1", 0)), p2=float(d.get("p2", 0)))
    if mt == "MEI":
        m = cfg.get("mirror_parameters", {}) or {}
        return MeiCamera(
            xi=float(m.get("xi", 1.0)),
            fx=float(p.get("gamma1", p.get("fx"))),
            fy=float(p.get("gamma2", p.get("fy"))),
            cx=float(p.get("u0", p.get("cx"))),
            cy=float(p.get("v0", p.get("cy"))),
            k1=float(d.get("k1", 0)), k2=float(d.get("k2", 0)),
            p1=float(d.get("p1", 0)), p2=float(d.get("p2", 0)))
    if mt in ("KANNALA_BRANDT", "EQUIDISTANT", "FISHEYE"):
        return EquidistantCamera(
            mu=float(p.get("mu", p.get("fx"))),
            mv=float(p.get("mv", p.get("fy"))),
            u0=float(p.get("u0", p.get("cx"))),
            v0=float(p.get("v0", p.get("cy"))),
            k2=float(d.get("k2", 0)), k3=float(d.get("k3", 0)),
            k4=float(d.get("k4", 0)), k5=float(d.get("k5", 0)))
    raise ValueError(f"unknown model_type {mt!r}")


class CameraBearings:
    """Adapter exposing numpy ``bearings(xy)`` for LoopCam: a LoopCam whose
    intrinsics carry a ``camera`` lifts its keypoints with that model."""

    def __init__(self, camera):
        self.camera = camera

    def bearings(self, xy: np.ndarray) -> np.ndarray:
        return self.camera.lift(np.asarray(xy, np.float32)).numpy()
