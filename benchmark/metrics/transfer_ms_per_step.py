"""transfer_ms_per_step: device time of the host <-> device copies of a
keyframe step's views and outputs in ``swarm/loop_cam.py``: the kernels
and memory operations whose innermost range is ``frontend/upload`` or
``frontend/download`` (``Trace.by_range``), in ms over the traced
window's keyframe steps. Nothing without a trace, or when neither range
holds device work (a program without these ranges)."""

RANGES = ("frontend/upload", "frontend/download")


def read(rec):
    n = rec.counts.get("steps")
    if rec.trace is None or not n:
        return None
    by = rec.trace.by_range()
    if not any(r in by for r in RANGES):
        return None
    return sum(by.get(r, 0.0) for r in RANGES) / 1e3 / n
