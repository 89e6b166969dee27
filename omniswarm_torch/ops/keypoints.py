"""Fixed-shape keypoint post-processing: NMS, top-K, descriptor sampling.

Counterpart of ``omniswarm_tpu/ops/keypoints.py``, batched over B where the
reference is vmapped:

- ``grid_nms`` is K2 (``ops/frontend_kernels.py``): the hand-written kernel
  for CUDA tensors, its plain version for CPU tensors. Unlike the reference,
  whose ``extract_keypoints`` calls the XLA ``grid_nms``, the port's
  production path runs the kernel.
- selection is a stable descending sort cut to K, so equal scores keep the
  lower flat index first exactly as ``jax.lax.top_k`` orders them (the
  zero-score slots past the valid keypoints included); ``torch.topk`` makes
  no such promise on the GPU.
- descriptor sampling is bilinear on the 1/8-resolution map, with
  ``grid_sample(align_corners=False)`` pixel-centre semantics.
"""
from __future__ import annotations

from typing import Tuple

import torch

from omniswarm_torch.ops.frontend_kernels import grid_nms  # noqa: F401


def extract_keypoints(
    heat: torch.Tensor, *, max_keypoints: int, threshold: float,
    nms_dist: int = 4, subpixel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K NMS'd keypoints of (B, H, W) heat maps.

    Returns (xy (B, K, 2) f32 [x, y], scores (B, K), valid (B, K) bool).
    ``subpixel`` refines each keypoint by the heat-weighted centroid of its
    3x3 neighbourhood (clamped at the border).
    """
    B, H, W = heat.shape
    nms = grid_nms(heat, nms_dist)
    flat = torch.where(nms > threshold, nms, 0.0).reshape(B, -1)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :max_keypoints], idx[:, :max_keypoints]
    valid = scores > threshold
    x = idx % W
    y = idx // W
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    if subpixel:
        heat_flat = heat.reshape(B, -1)
        num_x = torch.zeros_like(xf)
        num_y = torch.zeros_like(yf)
        den = torch.zeros_like(xf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                yi = torch.clamp(y + dy, 0, H - 1)
                xi = torch.clamp(x + dx, 0, W - 1)
                wgt = torch.clamp_min(
                    torch.gather(heat_flat, 1, yi * W + xi), 0.0)
                num_x = num_x + wgt * (x + dx).to(torch.float32)
                num_y = num_y + wgt * (y + dy).to(torch.float32)
                den = den + wgt
        den = torch.clamp_min(den, 1e-12)
        xf = torch.clamp(num_x / den, 0, W - 1)
        yf = torch.clamp(num_y / den, 0, H - 1)
    return torch.stack([xf, yf], dim=-1), scores, valid


def bilinear_sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor,
                                cell: int = 8) -> torch.Tensor:
    """Bilinearly sample (B, Hc, Wc, C) maps at pixel coords xy (B, K, 2).

    Pixel centres map to continuous coarse-grid coordinates as
    ``grid_sample(align_corners=False)`` does; neighbours outside the grid
    clamp to its edge. Returns (B, K, C).
    """
    B, Hc, Wc, _ = desc_map.shape
    gx = (xy[..., 0] + 0.5) / cell - 0.5
    gy = (xy[..., 1] + 0.5) / cell - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    b = torch.arange(B, device=desc_map.device)[:, None]

    def gather(yi, xi):
        yi = torch.clamp(yi.to(torch.int64), 0, Hc - 1)
        xi = torch.clamp(xi.to(torch.int64), 0, Wc - 1)
        return desc_map[b, yi, xi]

    d00 = gather(y0, x0)
    d01 = gather(y0, x0 + 1)
    d10 = gather(y0 + 1, x0)
    d11 = gather(y0 + 1, x0 + 1)
    return ((1 - wy) * ((1 - wx) * d00 + wx * d01)
            + wy * ((1 - wx) * d10 + wx * d11))
