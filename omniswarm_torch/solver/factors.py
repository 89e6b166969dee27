"""Robust-loss helpers (counterpart of omniswarm_tpu/solver/factors.py:153-172).

The jacfwd residual functions of the reference serve the generic solver
paths, which the port has not reached yet; the block-tridiagonal solve uses
analytic Jacobians (solver/dense.py).
"""
from __future__ import annotations

import torch


def huber_weight(residual: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS sqrt-weight for Ceres HuberLoss(delta) on whitened residual rows:
    1 if ||r|| <= delta else delta/||r||."""
    norm = torch.sqrt(torch.sum(residual * residual, dim=-1))
    return torch.where(norm <= delta, 1.0,
                       delta / torch.clamp_min(norm, 1e-12))


def huber_rho(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """Ceres HuberLoss rho(s): s if s<=delta^2 else 2*delta*sqrt(s)-delta^2."""
    d2 = delta * delta
    return torch.where(
        sq_norm <= d2, sq_norm,
        2.0 * delta * torch.sqrt(torch.clamp_min(sq_norm, 0.0)) - d2)
