"""Float32-precision control for the solver and the front-end.

Counterpart of ``omniswarm_tpu/core/precision.py``. On the GPU a float32
matmul may run through TF32 tensor cores (about three decimal digits), which
breaks the Newton-Schulz inverses and the refinement passes of the solver
exactly as JAX's bf16-grade default does on the TPU; and PyTorch runs f32
cuDNN convolutions in TF32 by default, whose ~1e-3 relative error in the
SuperPoint heat map flips keypoints near the detection threshold and the
top-K cut. ``highp`` scopes true float32 matmuls and convolutions over a
block or a function and restores the caller's settings on exit.

    with highp():
        ...

    @highp()
    def solve(...):
        ...
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highp():
    """Context manager (and, called, a decorator) for full-f32 matmuls and
    convolutions."""
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    saved_prec = torch.get_float32_matmul_precision()
    saved_conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved_conv_tf32
        torch.set_float32_matmul_precision(saved_prec)
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
