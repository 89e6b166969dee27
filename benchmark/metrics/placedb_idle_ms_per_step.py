"""placedb_idle_ms_per_step: device idle time whose gaps the trace labels
``placedb/`` (the host side of ``ops/placedb.py``: ``placedb/query``,
the mask build and the K3 launch, and ``placedb/add``, a keyframe's row
and metadata writes; the innermost host op at each gap's midpoint,
``Trace.idle_by_host``), in ms over the traced window's keyframe steps.

A lower bound: a gap whose midpoint falls inside a torch op within these
ranges (the writes' ``aten::copy_``, ``aten::select``) takes that op's
label. ``idle_by_host`` keeps the 10 largest labels: either range's label
absent from a shorter list reads 0, absent from a full list the tenth
label's value, an upper bound for that part. Nothing without a trace, or
from a program whose trace holds no ``frontend/upload`` range (one without
the keyframe step's host-phase ranges)."""

PREFIX = "placedb/"
LABELS = ("placedb/query", "placedb/add")


def read(rec):
    n = rec.counts.get("steps")
    if rec.trace is None or not n or not any(
            r[0] == "frontend/upload" for r in rec.trace.ranges):
        return None
    gaps = dict(rec.trace.idle_by_host)
    sec = sum(v for k, v in gaps.items() if k.startswith(PREFIX))
    missing = sum(label not in gaps for label in LABELS)
    if missing and len(rec.trace.idle_by_host) >= 10:
        sec += missing * rec.trace.idle_by_host[9][1]
    return sec * 1e3 / n
