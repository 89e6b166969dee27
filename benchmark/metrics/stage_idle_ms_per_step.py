"""stage_idle_ms_per_step: device idle time whose gap the trace labels
``frontend/stage`` (the host gathering, stacking and concatenating a
keyframe step's views in ``swarm/loop_cam.py``: the innermost host op at
the gap's midpoint, ``Trace.idle_by_host``), in ms over the traced
window's keyframe steps.

``idle_by_host`` keeps the 10 largest labels: a label absent from a
shorter list reads 0, one absent from a full list the tenth label's value,
an upper bound. Nothing without a trace, or from a program whose trace
holds no ``frontend/upload`` range (one without the keyframe step's
host-phase ranges)."""

LABEL = "frontend/stage"


def read(rec):
    n = rec.counts.get("steps")
    if rec.trace is None or not n or not any(
            r[0] == "frontend/upload" for r in rec.trace.ranges):
        return None
    gaps = dict(rec.trace.idle_by_host)
    if LABEL in gaps:
        sec = gaps[LABEL]
    elif len(rec.trace.idle_by_host) >= 10:
        sec = rec.trace.idle_by_host[9][1]
    else:
        sec = 0.0
    return sec * 1e3 / n
