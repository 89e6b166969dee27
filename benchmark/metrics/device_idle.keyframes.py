"""device_idle.keyframes: the share of the traced window of keyframe steps
in which no kernel ran on the device (100 - busy / window, busy the union
of kernel intervals in the profiler's trace)."""


def read(rec):
    if rec.trace is None or not rec.counts.get("steps"):
        return None
    return 100.0 * (1.0 - rec.trace.busy_us / 1e6 / rec.trace.window_s)
