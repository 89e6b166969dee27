"""views_per_s: every view of the window's keyframe steps (8 a drone: 4
directions x stereo) over the window's wall (host clock, whole steps)."""


def read(rec):
    n = rec.counts.get("views")
    return n / rec.window_s if n else None
