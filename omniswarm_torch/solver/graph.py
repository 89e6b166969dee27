"""Factor containers (counterpart of omniswarm_tpu/solver/graph.py:39, :107)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class RelPoseFactors(NamedTuple):
    """4-DoF relative pose factors (loop edges of the dense graph)."""

    frame_a: torch.Tensor    # (L,) int64
    drone_a: torch.Tensor    # (L,) int64
    frame_b: torch.Tensor    # (L,) int64
    drone_b: torch.Tensor    # (L,) int64
    dpose: torch.Tensor      # (L, 4)
    sqrt_info: torch.Tensor  # (L, 4, 4)
    valid: torch.Tensor      # (L,) bool


def empty_relpose(capacity: int, dtype=torch.float32,
                  device="cpu") -> RelPoseFactors:
    zi = torch.zeros((capacity,), dtype=torch.int64, device=device)
    return RelPoseFactors(
        zi, zi, zi, zi,
        torch.zeros((capacity, 4), dtype=dtype, device=device),
        torch.zeros((capacity, 4, 4), dtype=dtype, device=device),
        torch.zeros((capacity,), dtype=torch.bool, device=device),
    )
