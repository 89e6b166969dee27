"""k2_roofline: K2's (``grid_nms_kernel``) share of its roofline in the
traced window. A launch suppresses a step's heat maps, one a view (8 a
drone) at the configuration's size: the least time is their f32 bytes in
and out over 3.35 TB/s, times the launches; the time is K2's device time
by kernel name. Nothing when no K2 kernel ran."""
from benchmark.frozen.work import bound


def read(rec):
    if rec.trace is None:
        return None
    us, launches = rec.trace.kernel_us("grid_nms")
    if not launches:
        return None
    fe = rec.config["frontend"]
    views = 8 * rec.config["swarm"]["drones"]
    nbytes = 2 * views * fe["height"] * fe["width"] * 4
    return 100.0 * launches * bound(nbytes, 0) / (us / 1e6)
