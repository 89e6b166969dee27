"""The front-end's hand-written kernels and their plain versions.

Counterpart of ``omniswarm_tpu/ops/pallas_kernels.py``:

- ``grid_nms`` (K2, replaces ``grid_nms_pallas``): window-max non-maximum
  suppression of a (B, H, W) batch of SuperPoint heat maps;
  csrc/grid_nms.cu.
- ``retrieval_top1`` (K3, replaces ``retrieval_top1_pallas``): Q masked
  top-1 searches of an (N, D) global-descriptor DB; csrc/retrieval_top1.cu.
- ``conv_epilogue`` (replaces no TPU kernel: XLA fuses it there): bias,
  ReLU and 2 x 2 max-pool of a SuperPoint convolution's output in one pass;
  csrc/conv_epilogue.cu.
- ``conv3x3`` (C1, replaces no TPU kernel: XLA runs the convolution there):
  a stride-1, pad-1, 3 x 3 f32 convolution without bias, NCHW, as a direct
  implicit GEMM on f32 FMAs; csrc/conv3x3.cu. Its weights are re-laid once
  by ``conv3x3_weight``.

A CUDA tensor goes to the hand-written kernel (through
``omniswarm_torch.kernels``) and a CPU tensor to the plain version
(``grid_nms_ref``, ``retrieval_top1_ref``, ``conv_epilogue_ref``,
``conv3x3_ref``). Each dispatcher keeps a plain integer ``.launches`` count
of kernel launches and each plain version a ``.calls`` count.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def grid_nms_ref(heat: torch.Tensor, nms_dist: int = 4) -> torch.Tensor:
    """Plain PyTorch NMS of (B, H, W) heat maps, any device.

    A cell survives (keeps its value) iff it is >= every cell of its
    (2 nms_dist + 1)^2 window; else 0. The window max is taken rows first,
    then columns, by shifted maxima over a -inf border (no wrap-around), as
    the TPU kernel does; plateau ties keep every equal cell.
    """
    grid_nms_ref.calls += 1
    r = nms_dist
    H, W = heat.shape[-2:]
    padded = F.pad(heat, (r, r, r, r), value=float("-inf"))
    rowmax = padded[..., r:r + H, :]
    for d in range(1, r + 1):
        rowmax = torch.maximum(rowmax, padded[..., r - d:r - d + H, :])
        rowmax = torch.maximum(rowmax, padded[..., r + d:r + d + H, :])
    winmax = rowmax[..., r:r + W]
    for d in range(1, r + 1):
        winmax = torch.maximum(winmax, rowmax[..., r - d:r - d + W])
        winmax = torch.maximum(winmax, rowmax[..., r + d:r + d + W])
    return torch.where(heat >= winmax, heat, 0.0)


grid_nms_ref.calls = 0


def grid_nms(heat: torch.Tensor, nms_dist: int = 4) -> torch.Tensor:
    """K2: NMS of (B, H, W) f32 heat maps; the CUDA kernel for CUDA tensors,
    else the plain version. Same contract as ``grid_nms_ref``."""
    if heat.device.type == "cpu":
        return grid_nms_ref(heat, nms_dist)
    from omniswarm_torch import kernels

    out = kernels.grid_nms(heat, nms_dist)         # raises off-GPU
    grid_nms.launches += 1
    return out


grid_nms.launches = 0


def retrieval_top1_ref(db: torch.Tensor, query: torch.Tensor,
                       mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked top-1 retrieval, any device.

    db (N, D), query (Q, D), mask (Q, N) bool. Returns (best_idx (Q,)
    int64, best_sim (Q,) f32): the argmax of ``query @ db.T`` with masked
    entries at -inf, the lowest index among equal maxima; (0, -inf) when a
    query's every entry is masked.
    """
    retrieval_top1_ref.calls += 1
    sims = torch.where(mask, query @ db.T, float("-inf"))
    best = torch.argmax(sims, dim=1)
    return best, torch.gather(sims, 1, best[:, None])[:, 0]


retrieval_top1_ref.calls = 0


def retrieval_top1(db: torch.Tensor, query: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: masked top-1 retrieval; the CUDA kernel for CUDA tensors (one
    launch for all Q queries), else the plain version. Same contract as
    ``retrieval_top1_ref``."""
    if db.device.type == "cpu":
        return retrieval_top1_ref(db, query, mask)
    from omniswarm_torch import kernels

    out = kernels.retrieval_top1(db, query, mask)  # raises off-GPU
    retrieval_top1.launches += 1
    return out


retrieval_top1.launches = 0


def conv_epilogue_ref(x: torch.Tensor, bias: torch.Tensor, relu: bool,
                      pool: bool) -> torch.Tensor:
    """Plain epilogue of an (N, C, H, W) convolution output, any device:
    ``x + bias`` per channel, then ``F.relu`` if ``relu``, then
    ``F.max_pool2d(., 2, 2)`` if ``pool``. A new tensor; ``x`` is kept."""
    conv_epilogue_ref.calls += 1
    y = x + bias.view(1, -1, 1, 1)
    if relu:
        y = F.relu(y)
    return F.max_pool2d(y, 2, 2) if pool else y


conv_epilogue_ref.calls = 0


def conv_epilogue(x: torch.Tensor, bias: torch.Tensor, relu: bool,
                  pool: bool) -> torch.Tensor:
    """Bias, ReLU and 2 x 2 max-pool of a convolution's output; the CUDA
    kernel for CUDA tensors (f32, contiguous; the pool only after the ReLU;
    without the pool it writes into ``x``, so use the result and not ``x``),
    else the plain version. Same values as ``conv_epilogue_ref``, bit for
    bit. The kernel has no backward: it refuses inputs that would record
    one."""
    if x.device.type == "cpu":
        return conv_epilogue_ref(x, bias, relu, pool)
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        raise ValueError("conv_epilogue has no backward: call it under "
                         "torch.no_grad()")
    from omniswarm_torch import kernels

    out = kernels.conv_epilogue(x, bias, relu, pool)  # raises off-GPU
    conv_epilogue.launches += 1
    return out


conv_epilogue.launches = 0


def conv3x3_weight(weight: torch.Tensor) -> torch.Tensor:
    """A 3 x 3 convolution's weight (K, C, 3, 3) in C1's layout
    (K / 64, C, 9, 64): ``out[kb, c, 3 r + s, k] = weight[64 kb + k, c, r,
    s]``, contiguous, on the weight's device. K must be a multiple of 64."""
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"weight has shape {tuple(weight.shape)}: C1 takes "
                         f"3 x 3 kernels")
    K, C = weight.shape[:2]
    if K % 64:
        raise ValueError(f"{K} output channels: C1 takes a multiple of 64")
    return weight.detach().reshape(K // 64, 64, C, 9).permute(
        0, 2, 3, 1).contiguous()


def conv3x3_ref(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain stride-1, pad-1 convolution of x (N, C, H, W) by weight
    (K, C, 3, 3), without bias, any device: ``F.conv2d``."""
    conv3x3_ref.calls += 1
    return F.conv2d(x, weight, None, 1, 1)


conv3x3_ref.calls = 0


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            relaid: torch.Tensor) -> torch.Tensor:
    """C1: a stride-1, pad-1, 3 x 3 convolution without bias; the CUDA
    kernel for CUDA tensors (f32, contiguous, C a multiple of 8, K of 64;
    ``relaid`` is ``conv3x3_weight(weight)``, which the kernel reads),
    else the plain version (on ``weight``). The same products and sums as
    ``conv3x3_ref`` in a fixed order (c, then r, then s): equal to
    rounding, and the same bits call after call. The kernel has no
    backward: it refuses inputs that would record one."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, weight)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise ValueError("conv3x3 has no backward: call it under "
                         "torch.no_grad()")
    from omniswarm_torch import kernels

    out = kernels.conv3x3(x, relaid)                   # raises off-GPU
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
