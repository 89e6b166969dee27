"""depth_lift_ms_per_step: device time of the kernels inside the program's
``frontend/depth_lift`` range (the RGB-D path's depth lookup at each
keypoint, the lift along its ray, the depth gate and the turn into the
body frame; each kernel to the innermost range whose device span holds
its start) in the traced window, over its keyframe steps. Nothing without
a trace, or when the range holds no device work (a program without it)."""

RANGE = "frontend/depth_lift"


def read(rec):
    n = rec.counts.get("steps")
    if rec.trace is None or not n:
        return None
    us = rec.trace.by_range().get(RANGE)
    return us / 1e3 / n if us else None
