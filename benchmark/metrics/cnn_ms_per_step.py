"""cnn_ms_per_step: device time of the kernels inside the program's
``frontend/superpoint_net`` and ``frontend/netvlad`` ranges (each kernel
to the innermost range whose device span holds its start) in the traced
window, over its keyframe steps."""


def read(rec):
    n = rec.counts.get("steps")
    if rec.trace is None or not n:
        return None
    by = rec.trace.by_range()
    us = by.get("frontend/superpoint_net", 0.0) + by.get("frontend/netvlad",
                                                          0.0)
    return us / 1e3 / n if us else None
