"""The benchmark's frozen yardstick: the card's published peaks and the
operations and bytes of the work the cells ask for, from shapes alone.

``bound`` is a copy of the port's ``benchutil.bound``. The convolution
counts are taken from the published layer shapes of SuperPoint (DeTone et
al., 2018) and of the bundled MobileNetVLAD v2 at the configuration's
image size: 2 FLOPs a multiply-add of every convolution; biases,
activations, pooling, normalisation and the NetVLAD pooling are not
counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound(nbytes: float, ops: float) -> float:
    """Least seconds for moving ``nbytes`` and doing ``ops`` FP32
    operations on the card."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def conv_flops(h: int, w: int, cin: int, cout: int, k: int,
               groups: int = 1) -> int:
    """2 x multiply-adds of a stride-1 'same' convolution on h x w."""
    return 2 * h * w * cout * (cin // groups) * k * k


def superpoint_flops(h: int, w: int) -> int:
    """Convolution FLOPs of one SuperPoint view at h x w: the VGG encoder
    (64, 64 /2 64, 64 /2 128, 128 /2 128, 128), the detector head (128 ->
    256 3x3 -> 65 1x1) and the descriptor head (128 -> 256 3x3 -> 256 1x1)
    at 1/8 resolution."""
    layers = ((1, 64, 1), (64, 64, 1), (64, 64, 2), (64, 64, 2),
              (64, 128, 4), (128, 128, 4), (128, 128, 8), (128, 128, 8))
    total = sum(conv_flops(h // s, w // s, ci, co, 3) for ci, co, s in layers)
    hc, wc = h // 8, w // 8
    total += conv_flops(hc, wc, 128, 256, 3) + conv_flops(hc, wc, 256, 65, 1)
    total += conv_flops(hc, wc, 128, 256, 3) + conv_flops(hc, wc, 256, 256, 1)
    return total


def mobilenetvlad_v2_flops(h: int, w: int) -> int:
    """Convolution FLOPs of one MobileNetVLAD v2 view at h x w: a 3x3
    stride-2 stem to 32 channels, then depthwise 3x3 + pointwise blocks to
    (64, /2 128, 128, /2 256, 256, /2 512, 512), 'same' padding."""
    ceil = lambda n, s: -(-n // s)
    h, w = ceil(h, 2), ceil(w, 2)
    total = conv_flops(h, w, 1, 32, 3)
    cin = 32
    for cout, s in ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                    (512, 2), (512, 1)):
        h, w = ceil(h, s), ceil(w, s)
        total += conv_flops(h, w, cin, cin, 3, groups=cin)
        total += conv_flops(h, w, cin, cout, 1)
        cin = cout
    return total


def keyframe_step_flops(drones: int, h: int, w: int) -> int:
    """A keyframe step's convolution FLOPs: SuperPoint on all 8 views of
    every drone (4 directions x stereo), MobileNetVLAD on the 4 left."""
    return (8 * drones * superpoint_flops(h, w)
            + 4 * drones * mobilenetvlad_v2_flops(h, w))
