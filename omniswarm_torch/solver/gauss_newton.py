"""LM result container and step update
(counterpart of omniswarm_tpu/solver/gauss_newton.py:37-42, :204-207)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from omniswarm_torch.core import geometry as geo


class SolveResult(NamedTuple):
    poses: torch.Tensor         # (F, D, 4)
    cost: torch.Tensor          # () final cost (Ceres convention)
    initial_cost: torch.Tensor  # ()
    iterations: int             # accepted + rejected LM iterations
    lam: torch.Tensor           # () final damping


def _apply_step(poses: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    F, D, _ = poses.shape
    new = poses + dx.reshape(F, D, 4)
    return torch.cat([new[..., :3], geo.normalize_angle(new[..., 3:])], -1)
