"""Batched two-view midpoint triangulation.

Counterpart of ``omniswarm_tpu/ops/triangulation.py`` (:17-62), batched over
any leading dimensions. The 3x3 systems go through
``torch.linalg.solve_ex``, which skips the singularity check: an exactly
degenerate ray pair gives inf or NaN (the ``1e-9 I`` term vanishes in f32
next to entries of 1), as ``jnp.linalg.solve`` does, and the caller masks
it with ``isfinite``. ``torch.linalg.solve`` would raise instead.
"""
from __future__ import annotations

from typing import Tuple

import torch


def triangulate_rays(origins_a: torch.Tensor, dirs_a: torch.Tensor,
                     origins_b: torch.Tensor, dirs_b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Midpoint triangulation of ray pairs.

    All inputs (..., 3); directions unit. Returns (points (..., 3),
    error (...) = RMS distance of the point to the two rays).
    """
    eye = torch.eye(3, dtype=origins_a.dtype, device=origins_a.device)

    def proj(d):
        return eye - d[..., :, None] * d[..., None, :]       # (..., 3, 3)

    Pa, Pb = proj(dirs_a), proj(dirs_b)
    A = Pa + Pb
    rhs = (Pa @ origins_a[..., None] + Pb @ origins_b[..., None])
    A = A + 1e-9 * eye
    pts = torch.linalg.solve_ex(A, rhs)[0][..., 0]

    def ray_dist(p, o, d):
        v = p - o
        perp = v - torch.sum(v * d, -1, keepdim=True) * d
        return torch.sum(perp * perp, -1)

    err = torch.sqrt(0.5 * (ray_dist(pts, origins_a, dirs_a)
                            + ray_dist(pts, origins_b, dirs_b)))
    return pts, err


def triangulate_stereo(bearings_left: torch.Tensor,
                       bearings_right: torch.Tensor, baseline: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo triangulation in the left-camera frame.

    Bearings are unit rays (..., 3) in each camera frame; the right camera
    is translated +baseline along x (rectified stereo).
    """
    o_a = torch.zeros_like(bearings_left)
    o_b = torch.zeros_like(bearings_left)
    o_b[..., 0] = baseline
    return triangulate_rays(o_a, bearings_left, o_b, bearings_right)
