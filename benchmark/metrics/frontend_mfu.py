"""frontend_mfu: the traced window's keyframe steps' convolution FLOPs
(``frozen.work.keyframe_step_flops``, from the published layer shapes at
the configuration's image size) over the traced window's wall, as a share
of the card's float32 peak (67 TFLOP/s, the configuration's precision:
true float32 convolutions)."""
from benchmark.frozen.work import FP32_FLOPS_PER_S, keyframe_step_flops


def read(rec):
    n = rec.counts.get("steps")
    if rec.trace is None or not n:
        return None
    fe = rec.config["frontend"]
    flops = n * keyframe_step_flops(rec.config["swarm"]["drones"],
                                    fe["height"], fe["width"])
    return 100.0 * flops / rec.trace.window_s / FP32_FLOPS_PER_S
