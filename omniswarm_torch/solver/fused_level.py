"""One warm cyclic-reduction level of ``bt_factor`` as a single kernel launch.

Counterpart of ``omniswarm_tpu/solver/pallas_level.py::fused_reduction_level``.
For every block pair i < t = Fl/2 it computes the guarded, Jacobi-scaled,
warm-started Newton-Schulz inverse of A[2i+1] (2 squarings) and the
reduction operators of the level:

    W_l = B[2i] Ainv,  W_r = B[2i+1]^T Ainv,  A_new = A[2i] - W_l B[2i]^T,
    corr_l = W_r B[2i+1],  B_new = -W_l B[2i+1]

plus pass-through copies of B_left and B_right. The one-row-shifted add
``A_new[1:] -= corr_l[:-1]`` and the drop of the last B_new row happen
outside the kernel, as in the reference.

A CUDA tensor goes to the hand-written kernel (csrc/fused_level.cu, through
``omniswarm_torch.kernels``); a CPU tensor goes to the plain version
``fused_reduction_level_ref``. Each keeps a plain integer count:
``fused_reduction_level.launches`` counts kernel launches and
``fused_reduction_level_ref.calls`` counts calls of the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

Level = Tuple[torch.Tensor, ...]


def _pad_b(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """B padded to Fl rows so B[2i+1] exists for the last pair (zero)."""
    Fl, m = A.shape[0], A.shape[1]
    return torch.cat([B, B.new_zeros((Fl - B.shape[0], m, m))], 0)


def _finish(Ainv, W_l, W_r, A_new, corr_l, B_new, B_left, B_right) -> Level:
    A_new = torch.cat([A_new[:1], A_new[1:] - corr_l[:-1]], 0)
    return Ainv, B_left, B_right, W_l, W_r, A_new, B_new[:-1]


def _level_pairs_ref(A: torch.Tensor, Bp: torch.Tensor, X0: torch.Tensor,
                     guard: float) -> Level:
    """Plain per-pair level on padded B: the kernel's 8 outputs, in the
    kernel's order (Ainv, W_l, W_r, A_new, corr_l, B_new, B_left, B_right)."""
    m = A.shape[-1]
    A_even, A_odd = A[0::2], A[1::2]
    B_left, B_right = Bp[0::2], Bp[1::2]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    d = torch.diagonal(A_odd, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    ss = s[:, :, None] * s[:, None, :]
    An = A_odd * ss
    X0n = X0 / torch.clamp_min(ss, 1e-30)
    # the guard residual doubles as the first iteration's inner product
    M = An @ X0n
    enorm = torch.abs(eye - M).sum(-1).amax(-1)
    rho = torch.abs(An).sum(-1).amax(-1)
    bad = ((enorm > guard) | ~torch.isfinite(enorm))[:, None, None]
    rho_ = rho[:, None, None]
    X = torch.where(bad, eye / rho_, X0n)
    M = torch.where(bad, An / rho_, M)
    two_eye = 2.0 * eye
    X = X @ (two_eye - M)
    X = X @ (two_eye - An @ X)
    Ainv = X * ss
    W_l = B_left @ Ainv
    W_r = B_right.mT @ Ainv
    A_new = A_even - W_l @ B_left.mT
    corr_l = W_r @ B_right
    B_new = -(W_l @ B_right)
    return (Ainv, W_l, W_r, A_new, corr_l, B_new,
            B_left.contiguous(), B_right.contiguous())


def fused_reduction_level_ref(A: torch.Tensor, B: torch.Tensor,
                              X0: torch.Tensor, guard: float = 0.95
                              ) -> Level:
    """Plain PyTorch version of the fused level, any device.

    A: (Fl, m, m) (Fl even), B: (Fl-1, m, m), X0: (Fl/2, m, m), all f32.
    Returns (Ainv, B_left, B_right, W_l, W_r, A_new, B_new) with the
    shifted corr_left add and the trailing B_new row dropped.
    """
    fused_reduction_level_ref.calls += 1
    return _finish(*_level_pairs_ref(A, _pad_b(A, B), X0, guard))


fused_reduction_level_ref.calls = 0


def fused_reduction_level(A: torch.Tensor, B: torch.Tensor,
                          X0: torch.Tensor, guard: float = 0.95) -> Level:
    """Fused level: the CUDA kernel for CUDA tensors, else the plain version.

    Same contract as ``fused_reduction_level_ref``. A CUDA input never
    reaches the plain version: the kernel launches or the call raises.
    """
    if A.device.type == "cpu":
        return fused_reduction_level_ref(A, B, X0, guard)
    from omniswarm_torch import kernels

    outs = kernels.fused_level(A, _pad_b(A, B), X0, guard)   # raises off-GPU
    fused_reduction_level.launches += 1
    return _finish(*outs)


fused_reduction_level.launches = 0
