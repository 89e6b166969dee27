"""MobileNetVLAD global image descriptor as a ``torch.nn`` module.

Counterpart of ``omniswarm_tpu/models/netvlad.py`` (:20-235): a MobileNet
depthwise-separable encoder (v1 plain, v2 with GroupNorm and one more
block) and NetVLAD pooling (soft assignment, residual aggregation,
intra-normalisation, global L2, optional linear projection), in NCHW.
Weights come from the reference's bundled Flax checkpoint through
``convert.netvlad_params_from_flax``. The bundled checkpoint is v2 with
8 clusters x 512 channels = 4096 dimensions and no projection.

Where the reference differs from PyTorch's defaults:

- Flax ``padding="SAME"`` with stride 2 pads asymmetrically: XLA pads
  ``lo = total // 2`` and ``hi = total - lo``, so a 3x3 stride-2 conv on an
  even size pads (0, 1) where ``padding=1`` pads (1, 1). Every 3x3 conv
  here pads explicitly with that formula and convolves with ``padding=0``.
- Flax's GroupNorm epsilon is 1e-6 (PyTorch's default is 1e-5).
- Normalisations divide by ``max(norm, 1e-8)``.

``dtype=torch.bfloat16`` runs the encoder as the reference's ``dtype``
does: the image and each conv's f32 weight and bias are rounded to bf16 at
every call and the convs and ReLUs run in bf16; each GroupNorm runs in f32
and its ReLU's output is cast back to bf16 (the reference's :62-69,
:86-88); NetVLAD pools in f32 (:113). The weights stay f32.

For training (``models/train_netvlad.py``): ``init_mobilenetvlad`` draws
Flax's default initialisation and ``save_netvlad_npz`` writes the
reference's checkpoint layout.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.models.superpoint import (WEIGHTS_DIR, CastConv2d,
                                               _unit, lecun_normal_)

DEFAULT_WEIGHTS = WEIGHTS_DIR / "netvlad_v2_revisit.npz"
# bundled checkpoint architecture: K*C = 8*512 = 4096 = out_dim, no proj
BUNDLED_CLUSTERS = 8
BUNDLED_OUT_DIM = 4096
GN_EPS = 1e-6


def _same_pad(size: int, k: int, stride: int):
    """XLA's (lo, hi) padding of one spatial axis for padding="SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(CastConv2d):
    """Conv2d with Flax/XLA ``padding="SAME"`` (asymmetric at stride 2), in
    the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pad(x.shape[-2], k, s)
        left, right = _same_pad(x.shape[-1], k, s)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          bias: bool = True) -> nn.Conv2d:
    if k == 1:
        return CastConv2d(cin, cout, 1, bias=bias)
    return SameConv2d(cin, cout, k, stride=stride, groups=groups, bias=bias)


class SeparableConv(nn.Module):
    """v1 block: depthwise 3x3 (stride s) + ReLU, pointwise 1x1 + ReLU, in
    ``dtype``."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dw = _conv(cin, cin, 3, stride, groups=cin)
        self.pw = _conv(cin, features, 1)

    def forward(self, x):
        return F.relu(self.pw(F.relu(self.dw(x.to(self.dtype)))))


class MobileNetEncoder(nn.Module):
    """v1 encoder: (B, 1, H, W) -> (B, 512, H/16, W/16) in ``dtype``."""

    BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2))

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = _conv(1, 32, 3, 2)
        cin = 32
        for i, (c, s) in enumerate(self.BLOCKS):
            self.add_module(f"sep{i}", SeparableConv(cin, c, s, dtype))
            cin = c

    def forward(self, x):
        x = F.relu(self.stem(x.to(self.dtype)))
        for i in range(len(self.BLOCKS)):
            x = getattr(self, f"sep{i}")(x)
        return x


class SeparableConvGN(nn.Module):
    """v2 block: depthwise/pointwise convs (no bias) in ``dtype``, each with
    GroupNorm in f32 + ReLU, cast back to ``dtype``."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dw = _conv(cin, cin, 3, stride, groups=cin, bias=False)
        self.dw_gn = nn.GroupNorm(min(32, cin), cin, eps=GN_EPS)
        self.pw = _conv(cin, features, 1, bias=False)
        self.pw_gn = nn.GroupNorm(min(32, features), features, eps=GN_EPS)

    def forward(self, x):
        x = F.relu(self.dw_gn(self.dw(x.to(self.dtype)).float()))
        x = F.relu(self.pw_gn(self.pw(x.to(self.dtype)).float()))
        return x.to(self.dtype)


class MobileNetEncoderV2(nn.Module):
    """v2 encoder (GroupNorm, one block deeper): (B, 1, H, W) ->
    (B, 512, H/16, W/16) in ``dtype``."""

    BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
              (512, 1))

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = _conv(1, 32, 3, 2, bias=False)
        self.stem_gn = nn.GroupNorm(8, 32, eps=GN_EPS)
        cin = 32
        for i, (c, s) in enumerate(self.BLOCKS):
            self.add_module(f"sep{i}", SeparableConvGN(cin, c, s, dtype))
            cin = c

    def forward(self, x):
        x = F.relu(self.stem_gn(self.stem(x.to(self.dtype)).float()))
        x = x.to(self.dtype)
        for i in range(len(self.BLOCKS)):
            x = getattr(self, f"sep{i}")(x)
        return x


class NetVLAD(nn.Module):
    """NetVLAD pooling in f32: (B, C, H, W) -> (B, K*C) (K-major), then
    the optional projection to ``out_dim``; unit vectors."""

    def __init__(self, num_clusters: int = 64, dim: int = 512,
                 out_dim: int = 4096, use_proj: bool = True):
        super().__init__()
        self.assign = nn.Linear(dim, num_clusters)
        self.centroids = nn.Parameter(torch.zeros(num_clusters, dim))
        self.proj = (nn.Linear(num_clusters * dim, out_dim, bias=False)
                     if use_proj else None)

    def forward(self, x):
        B, C = x.shape[:2]
        feats = x.reshape(B, C, -1).transpose(1, 2).float()  # (B, N, C)
        assign = torch.softmax(self.assign(feats), dim=-1)   # (B, N, K)
        agg = assign.transpose(1, 2) @ feats                 # (B, K, C)
        mass = assign.sum(dim=1)                             # (B, K)
        vlad = agg - mass[..., None] * self.centroids[None]
        vlad = _unit(vlad, dim=-1).reshape(B, -1)
        vlad = _unit(vlad, dim=-1)
        if self.proj is None:
            return vlad
        return _unit(self.proj(vlad), dim=-1)


class MobileNetVLAD(nn.Module):
    """images (B, 1, H, W) grayscale in [0, 1] -> (B, out_dim) unit, f32;
    the encoder runs in ``dtype``."""

    def __init__(self, num_clusters: int = 64, out_dim: int = 4096,
                 use_proj: bool = True, encoder_version: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = (MobileNetEncoderV2(dtype) if encoder_version >= 2
                        else MobileNetEncoder(dtype))
        self.vlad = NetVLAD(num_clusters, 512, out_dim, use_proj)

    def forward(self, images):
        return self.vlad(self.encoder(images))


class GlobalDescriptorExtractor(nn.Module):
    """MobileNetVLAD with loaded weights: call with (B, 1, H, W) images in
    [0, 1], get (B, out_dim) unit descriptors (f32; the encoder in
    ``dtype``)."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], *,
                 num_clusters: int = 64, out_dim: int = 4096,
                 use_proj: bool = True, encoder_version: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = MobileNetVLAD(num_clusters, out_dim, use_proj,
                                   encoder_version, dtype)
        self.load_state_dict(state_dict)

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images)


def init_mobilenetvlad(generator: torch.Generator,
                       encoder_version: int = 1, *,
                       num_clusters: int = BUNDLED_CLUSTERS,
                       out_dim: int = BUNDLED_OUT_DIM,
                       use_proj: bool = False) -> MobileNetVLAD:
    """A MobileNetVLAD (on the CPU; by default of the bundled architecture)
    with Flax's default initialisation drawn from ``generator``:
    ``lecun_normal`` conv and Dense kernels (a depthwise kernel's fan_in is
    9), zero biases, GroupNorm scale 1 and bias 0, and centroids drawn
    from N(0, 0.1^2) (``netvlad.py:116-118`` of the reference)."""
    model = MobileNetVLAD(num_clusters, out_dim, use_proj, encoder_version)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    with torch.no_grad():
        model.vlad.centroids.normal_(0.0, 0.1, generator=generator)
    return model


def model_state(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``MobileNetVLAD`` state_dict inside ``params``: that state dict
    itself (``encoder.stem.weight`` ...) or an extractor's
    (``model.encoder.stem.weight`` ...)."""
    return {(k[6:] if k.startswith("model.") else k): v
            for k, v in params.items()}


def save_netvlad_npz(params: Dict[str, torch.Tensor], path, *,
                     encoder_version: int = 1) -> None:
    """Write ``params`` (a ``MobileNetVLAD`` or extractor state_dict) as
    the reference's ``save_netvlad_npz`` does: flat Flax paths in f16 and
    ``__encoder_version``, compressed. The reference's
    ``load_netvlad_npz`` and ``netvlad_meta`` read it."""
    from omniswarm_torch.convert import netvlad_params_to_flax

    out = {k: v.astype(np.float16)
           for k, v in netvlad_params_to_flax(params).items()}
    out["__encoder_version"] = np.asarray(encoder_version, np.int32)
    np.savez_compressed(path, **out)


def load_netvlad_npz(path) -> Dict[str, np.ndarray]:
    """Flat Flax-layout MobileNetVLAD parameters (``/`` paths, f32 numpy)
    of a checkpoint saved by the reference's ``save_netvlad_npz``."""
    raw = np.load(path)
    return {k: np.asarray(raw[k], np.float32) for k in raw.files
            if not k.startswith("__")}


def netvlad_meta(path) -> Dict[str, int]:
    """Checkpoint architecture metadata (encoder_version; v1 if absent)."""
    raw = np.load(path)
    ver = (int(raw["__encoder_version"])
           if "__encoder_version" in raw.files else 1)
    return {"encoder_version": ver}


def pretrained_global_extractor(device="cuda", *, path=DEFAULT_WEIGHTS,
                                dtype: torch.dtype = torch.float32,
                                **kw) -> GlobalDescriptorExtractor:
    """GlobalDescriptorExtractor with the bundled checkpoint, on
    ``device`` (the GPU unless the CPU is asked for), its encoder in
    ``dtype`` (f32 weights either way)."""
    from omniswarm_torch.convert import netvlad_params_from_flax

    dev = resolve_device(device)
    kw.setdefault("num_clusters", BUNDLED_CLUSTERS)
    kw.setdefault("out_dim", BUNDLED_OUT_DIM)
    kw.setdefault("use_proj", False)
    kw.setdefault("encoder_version", netvlad_meta(path)["encoder_version"])
    sd = netvlad_params_from_flax(load_netvlad_npz(path))
    return GlobalDescriptorExtractor(sd, dtype=dtype, **kw).to(dev).eval()
