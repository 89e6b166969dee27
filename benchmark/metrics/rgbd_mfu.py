"""rgbd_mfu: the traced window's RGB-D keyframe steps' convolution FLOPs
(drones x (``superpoint_flops`` + ``mobilenetvlad_v2_flops``) a step from
``frozen.work``, from the published layer shapes at the configuration's
image size: one view a drone through both networks) over the traced
window's wall, as a share of the card's float32 peak (67 TFLOP/s, the
configuration's precision: true float32 convolutions)."""
from benchmark.frozen.work import (FP32_FLOPS_PER_S, mobilenetvlad_v2_flops,
                                   superpoint_flops)


def read(rec):
    n = rec.counts.get("steps")
    if rec.trace is None or not n:
        return None
    fe = rec.config["frontend"]
    h, w = fe["height"], fe["width"]
    flops = n * rec.config["swarm"]["drones"] * (
        superpoint_flops(h, w) + mobilenetvlad_v2_flops(h, w))
    return 100.0 * flops / rec.trace.window_s / FP32_FLOPS_PER_S
