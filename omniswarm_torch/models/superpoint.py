"""SuperPoint keypoint detector and descriptor as a ``torch.nn`` module.

Counterpart of ``omniswarm_tpu/models/superpoint.py`` (:32-209): a VGG-style
shared encoder (64, 64 /2 64, 64 /2 128, 128 /2 128, 128), a 65-channel
detector head (8 x 8 cell pixels + dustbin) and a 256-d descriptor head,
in NCHW. ``SuperPointExtractor`` adds the fixed-shape post-processing (NMS
through K2, top-K, subpixel refinement, bilinear descriptor sampling) and
the PCA 256 -> 64. Weights come from the reference's bundled Flax checkpoint
(``omniswarm_tpu/models/weights/*.npz``, read as data with numpy) through
``convert.superpoint_params_from_flax``.

Every 3x3 convolution here has stride 1, where Flax's ``padding="SAME"``
is the symmetric ``padding=1``.

``dtype=torch.bfloat16`` runs the trunk as the reference's ``dtype`` does
(Flax's ``promote_dtype``): the image and each conv's f32 weight and bias
are rounded to bf16 (to nearest even) at every call, every conv, ReLU and
pool runs in bf16, and the detector logits and the descriptor head are cast
back to f32 (the reference's :62 and :69), so the heat map that reaches
K2 is f32. The weights stay f32 in the module.

f32 inference on the card (``fused_epilogue``: autograd off) convolves
without the bias and runs each convolution's bias, ReLU and 2 x 2 pool as
one launch of ``conv_epilogue`` (csrc/conv_epilogue.cu), 12 a forward, bit
for bit what the PyTorch ops give (PyTorch's cuDNN route adds the bias
after the convolution too). On the same path the nine 3 x 3 convolutions
with 64 or more input channels (all but ``conv1a`` and the two 1 x 1
heads) run on ``conv3x3`` (C1, csrc/conv3x3.cu), in true f32 with weights
re-laid once per module (``CastConv2d.relaid_weight``); ``conv1a`` and the
heads stay on cuDNN. C1 sums in the order of cuDNN's f32 implicit GEMM
(the same bits where cuDNN picks that algorithm) and differs by rounding
where cuDNN's heuristic picks its FFT path. ``SuperPoint.c1`` (True) is
cleared only by ``OmniLoopCam``, whose stereo batch keeps cuDNN's bits
(``swarm/loop_cam.py``). Training, the bf16 trunk and the CPU run the
PyTorch ops.

For training (``models/train_superpoint.py``): ``forward(return_logits=True)``
adds the raw detector logits, ``init_superpoint`` draws Flax's default
initialisation, and ``save_flax_npz`` / ``load_params_npz`` write the
reference's checkpoint layout and read torch-original OIHW weights.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.ops.frontend_kernels import (
    conv3x3,
    conv3x3_weight,
    conv_epilogue,
)
from omniswarm_torch.ops.keypoints import (
    bilinear_sample_descriptors,
    extract_keypoints,
)

WEIGHTS_DIR = (Path(__file__).resolve().parents[2] / "omniswarm_tpu"
               / "models" / "weights")
DEFAULT_WEIGHTS = WEIGHTS_DIR / "superpoint_photo_v2.npz"

_CONVS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
          ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
          ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
          ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
          ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
          ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))


def _unit(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / max(||x||, 1e-8) along ``dim`` (the reference's guard, not
    F.normalize's 1e-12)."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim,
                                                        keepdim=True), 1e-8)


C1_MIN_CHANNELS = 64     # 3 x 3 convolutions with this many inputs run C1


class CastConv2d(nn.Conv2d):
    """Conv2d in the dtype of its input: the f32 weight and bias are rounded
    to the input's dtype at each call (a no-op for f32 inputs)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def relaid_weight(self) -> torch.Tensor:
        """The weight in C1's layout (``conv3x3_weight``), made once and
        kept until the weight changes: the cache holds the weight's storage
        (so no new weight can take its address) and its version, which
        ``load_state_dict``'s in-place copy and any other in-place write
        advance."""
        w = self.weight
        key = (w.data_ptr(), w.device, w._version)
        cached = self.__dict__.get("_relaid")
        if cached is None or cached[0] != key:
            cached = (key, w.detach(), conv3x3_weight(w))
            self.__dict__["_relaid"] = cached
        return cached[2]


def fused_epilogue(x: torch.Tensor) -> bool:
    """Whether ``SuperPoint.forward`` runs its convolutions' epilogues
    through the ``conv_epilogue`` kernel on this input: f32 on the card
    with autograd off (the kernel has no backward; the bf16 trunk and the
    CPU keep the PyTorch ops)."""
    return (x.is_cuda and x.dtype == torch.float32
            and not torch.is_grad_enabled())


class SuperPoint(nn.Module):
    """images (B, 1, H, W) in [0, 1] -> (heat (B, H, W),
    desc (B, H/8, W/8, 256)), both f32 for either ``dtype`` (the trunk's);
    the descriptor map is returned channels-last, the reference's layout,
    as a view."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.c1 = True      # fused: the nine 3 x 3 convolutions run on C1
        for name, cin, cout, k in _CONVS:
            self.add_module(name, CastConv2d(cin, cout, k, padding=k // 2))

    def _conv(self, name: str, x: torch.Tensor, fused: bool,
              relu: bool = True, pool: bool = False) -> torch.Tensor:
        """Convolution ``name``, then ReLU and 2 x 2 max-pool as asked:
        ``fused``, the convolution without its bias (with ``self.c1``, C1
        for a 3 x 3 one with at least ``C1_MIN_CHANNELS`` inputs; else
        cuDNN) and one ``conv_epilogue`` launch for the rest; else the three
        PyTorch ops."""
        conv = getattr(self, name)
        if fused:
            if (self.c1 and conv.kernel_size == (3, 3)
                    and conv.in_channels >= C1_MIN_CHANNELS):
                y = conv3x3(x, conv.weight, conv.relaid_weight())
            else:
                y = conv._conv_forward(x, conv.weight, None)
            return conv_epilogue(y, conv.bias, relu, pool)
        x = conv(x)
        if relu:
            x = F.relu(x)
        return F.max_pool2d(x, 2, 2) if pool else x

    def forward(self, images: torch.Tensor, return_logits: bool = False):
        """(heat, desc) or, with ``return_logits``, (heat, desc, logits)
        where logits (B, H/8, W/8, 65) are the raw detector logits,
        channels-last as the reference returns them (a view)."""
        x = images.to(self.dtype)
        fused = fused_epilogue(x)
        for a, b in (("conv1a", "conv1b"), ("conv2a", "conv2b"),
                     ("conv3a", "conv3b")):
            x = self._conv(a, x, fused)
            x = self._conv(b, x, fused, pool=True)
        x = self._conv("conv4a", x, fused)
        x = self._conv("conv4b", x, fused)

        logits = self._conv("convPb", self._conv("convPa", x, fused), fused,
                            relu=False).float()          # (B, 65, Hc, Wc)
        semi = torch.softmax(logits, dim=1)[:, :64]
        B, _, Hc, Wc = semi.shape
        # depth-to-space: channel i*8 + j -> pixel (8 hc + i, 8 wc + j)
        heat = semi.reshape(B, 8, 8, Hc, Wc).permute(0, 3, 1, 4, 2)
        heat = heat.reshape(B, Hc * 8, Wc * 8)

        desc = self._conv("convDb", self._conv("convDa", x, fused), fused,
                          relu=False).float()
        desc = _unit(desc, dim=1).permute(0, 2, 3, 1)
        if return_logits:
            return heat, desc, logits.permute(0, 2, 3, 1)
        return heat, desc


# Flax's default kernel init, lecun_normal: a normal truncated to +-2 std,
# rescaled so that the truncated draw has variance 1 / fan_in
TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """Fill a conv (O, I/groups, kh, kw) or linear (O, I) weight in place
    with Flax's ``lecun_normal``; fan_in = (I/groups) kh kw, so a depthwise
    3x3 kernel has fan_in 9."""
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def init_superpoint(generator: torch.Generator) -> SuperPoint:
    """A SuperPoint (on the CPU) with Flax's default initialisation drawn
    from ``generator``: ``lecun_normal`` kernels and zero biases (PyTorch's
    own default, kaiming-uniform weights and uniform biases, starts
    training from another distribution)."""
    net = SuperPoint()
    for name, *_ in _CONVS:
        conv = getattr(net, name)
        lecun_normal_(conv.weight, generator)
        nn.init.zeros_(conv.bias)
    return net


def net_state(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``SuperPoint`` state_dict inside ``params``: either that state
    dict itself (``conv1a.weight`` ...) or an extractor's
    (``net.conv1a.weight`` ...); PCA entries are dropped."""
    return {(k[4:] if k.startswith("net.") else k): v
            for k, v in params.items()
            if k not in ("pca_components", "pca_mean")}


class SuperPointExtractor(nn.Module):
    """SuperPoint + fixed-shape post-processing + PCA projection, with
    the weights and PCA of ``state_dict`` (``convert``'s layout).

    Call with (B, 1, H, W) images in [0, 1]; returns (xy (B, K, 2) f32,
    scores (B, K), desc (B, K, pca_dim) unit, valid (B, K) bool).
    ``dtype``: the CNN trunk's (``SuperPoint``); the post-processing is f32.
    """

    def __init__(self, state_dict: Dict[str, torch.Tensor], *,
                 max_keypoints: int = 200, threshold: float = 0.012,
                 nms_dist: int = 4, pca_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = SuperPoint(dtype)
        self.max_keypoints = max_keypoints
        self.threshold = threshold
        self.nms_dist = nms_dist
        self.register_buffer("pca_components", torch.zeros(pca_dim, 256))
        self.register_buffer("pca_mean", torch.zeros(256))
        self.load_state_dict(state_dict)

    @torch.no_grad()
    def forward(self, images: torch.Tensor):
        with record_function("frontend/superpoint_net"):
            heat, desc_coarse = self.net(images)
        with record_function("frontend/keypoints"):
            xy, scores, valid = extract_keypoints(
                heat, max_keypoints=self.max_keypoints,
                threshold=self.threshold, nms_dist=self.nms_dist)
        with record_function("frontend/descriptors"):
            desc = _unit(bilinear_sample_descriptors(desc_coarse, xy,
                                                     cell=8), dim=-1)
            # PCA 256 -> 64 (reference: USE_PCA,
            # superpoint_tensorrt.cpp:192-230)
            desc = _unit((desc - self.pca_mean) @ self.pca_components.T,
                         dim=-1)
        return xy, scores, desc, valid


def load_flax_npz(path) -> Dict[str, np.ndarray]:
    """Flat Flax-layout parameters of a checkpoint saved by the reference's
    ``save_flax_npz``, as f32 numpy arrays keyed by their ``/`` paths;
    ``__``-prefixed extras (PCA) keep their key without the prefix."""
    raw = np.load(path)
    return {(k[2:] if k.startswith("__") else k):
            np.asarray(raw[k], np.float32) for k in raw.files}


def save_flax_npz(params: Dict[str, torch.Tensor], path) -> None:
    """Write ``params`` (a ``SuperPoint`` or extractor state_dict, with
    ``pca_components`` / ``pca_mean`` when present) as the reference's
    ``save_flax_npz`` does: flat ``params/<conv>/kernel`` (HWIO) and
    ``bias`` in f16, the PCA as ``__pca_components`` / ``__pca_mean``,
    compressed. The reference's ``load_flax_npz`` reads it."""
    from omniswarm_torch.convert import superpoint_params_to_flax

    flat = superpoint_params_to_flax(params)
    np.savez_compressed(path, **{
        (f"__{k}" if k in ("pca_components", "pca_mean") else k):
        v.astype(np.float16) for k, v in flat.items()})


def load_params_npz(path) -> Dict[str, torch.Tensor]:
    """Extractor state_dict (``net.conv1a.weight`` ..., plus the PCA when
    the file has one) from a torch-original checkpoint: ``<conv>.weight``
    in OIHW and ``<conv>.bias``, as ``tools/convert_superpoint.py``
    writes them; f32."""
    raw = np.load(path)
    out = {}
    for name, *_ in _CONVS:
        for leaf in ("weight", "bias"):
            out[f"net.{name}.{leaf}"] = torch.from_numpy(
                np.array(raw[f"{name}.{leaf}"], np.float32))
    for extra in ("pca_components", "pca_mean"):
        if extra in raw.files:
            out[extra] = torch.from_numpy(np.array(raw[extra], np.float32))
    return out


def pretrained_extractor(device="cuda", *, path=DEFAULT_WEIGHTS,
                         dtype: torch.dtype = torch.float32,
                         **kw) -> SuperPointExtractor:
    """SuperPointExtractor with the bundled photometric checkpoint (with
    its fitted PCA), on ``device`` (the GPU unless the CPU is asked for),
    its trunk in ``dtype`` (f32 weights either way)."""
    from omniswarm_torch.convert import superpoint_params_from_flax

    dev = resolve_device(device)
    flat = load_flax_npz(path)
    kw.setdefault("pca_dim", flat["pca_components"].shape[0])
    ext = SuperPointExtractor(superpoint_params_from_flax(flat), dtype=dtype,
                              **kw)
    return ext.to(dev).eval()
