"""keyframe_ms_p95: the 95th percentile (numpy's linear interpolation) of
the window's step times, each from the step's start until its retrieval
results are on the host (host clock, synchronised)."""
import numpy as np


def read(rec):
    if not rec.counts.get("steps"):
        return None
    return float(np.percentile(np.asarray(rec.unit_s) * 1e3, 95))
