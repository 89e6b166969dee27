"""k3_roofline: K3's (``retrieval_kernel``) share of its roofline in the
traced window. A launch reads the full PlaceDB (capacity x dimension f32),
a step's queries (one a drone, f32) and their (query x capacity) bool mask
and writes an index and a similarity a query: the least time is those
bytes over 3.35 TB/s, times the launches; the time is K3's device time by
kernel name. Nothing when no K3 kernel ran."""
from benchmark.frozen.work import bound


def read(rec):
    if rec.trace is None:
        return None
    us, launches = rec.trace.kernel_us("retrieval")
    if not launches:
        return None
    fe = rec.config["frontend"]
    n, g = fe["max_db_size"], fe["global_desc_dim"]
    q = rec.config["swarm"]["drones"]
    nbytes = n * g * 4 + q * g * 4 + q * n + q * (8 + 4)
    return 100.0 * launches * bound(nbytes, 0) / (us / 1e6)
