"""epilogue_roofline: the convolution epilogue kernel's (``conv_epilogue``:
bias, ReLU and 2 x 2 max-pool of SuperPoint's convolutions in one pass)
share of its roofline in the traced window. A SuperPoint forward launches
it 12 times, once a convolution, on a step's views (8 a drone) at the
configuration's size: the least time for one forward is its f32 bytes over
3.35 TB/s, each convolution's output read once and the activated output
written once (a quarter of it after the three pools); the biases are left
out, so the share errs low. The time is the kernel's device time by name,
for launches / 12 forwards. Nothing when no such kernel ran."""
from benchmark.frozen.work import bound

LAUNCHES_A_FORWARD = 12


def view_bytes(h: int, w: int) -> int:
    """Bytes the 12 epilogues of one SuperPoint view at h x w move: the
    VGG encoder's (64, 64 /2, 64, 64 /2, 128, 128 /2, 128, 128) outputs and
    the heads' 256, 65, 256 and 256 at 1/8 resolution, f32."""
    total = 0
    for cout, pool in ((64, False), (64, True), (64, False), (64, True),
                       (128, False), (128, True)):
        out_hw = (h // 2) * (w // 2) if pool else h * w
        total += 4 * cout * (h * w + out_hw)
        if pool:
            h, w = h // 2, w // 2
    for cout in (128, 128, 256, 65, 256, 256):
        total += 4 * cout * 2 * h * w
    return total


def read(rec):
    if rec.trace is None:
        return None
    us, launches = rec.trace.kernel_us("conv_epilogue")
    if not launches:
        return None
    fe = rec.config["frontend"]
    views = 8 * rec.config["swarm"]["drones"]
    nbytes = views * view_bytes(fe["height"], fe["width"])
    forwards = launches / LAUNCHES_A_FORWARD
    return 100.0 * forwards * bound(nbytes, 0) / (us / 1e6)
