"""The keyframe step's host-phase profiler ranges, on the CPU at small
sizes: 2 drones x 3 steps of 96 x 160 views through
``OmniLoopCam.on_fisheye_frames_batch``, then ``placedb.query_batch`` and
one ``placedb.add`` a keyframe (``frontend_entry.run_steps``), under
``torch.profiler``.

``frontend/stage`` and ``frontend/merge`` are entered at two sites each,
back to back on either side of ``extract_stereo_batch``: stage around the
gathering and stacking of the views and around their concatenation, merge
around the host casts and around the per-drone merge. A trace reader
labels an idle device gap by the innermost host op at its midpoint, so
these two ranges must hold no torch op; and a reader that gives each
kernel to its innermost ``frontend/`` or ``detector/`` range must find
none inside the CNN ranges.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from omniswarm_torch import frontend_entry as fe
from omniswarm_torch.swarm.loop_cam import OmniLoopCam

DRONES, STEPS = 2, 3
# the new ranges of one step, in the order the step enters them
STEP = (["frontend/stage"] * 2 + ["frontend/upload", "frontend/download"]
        + ["frontend/merge"] * 2 + ["placedb/query"]
        + ["placedb/add"] * DRONES)
HOST_ONLY = ("frontend/stage", "frontend/merge")
CNN = ("frontend/superpoint_net", "frontend/netvlad")


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        prep = fe.prepare(num_drones=DRONES, num_frames=2 * STEPS,
                          kf_every=2, height=96, width=160)
        cam = OmniLoopCam(params=prep.fp, intrinsics=prep.intr,
                          baseline=fe.BASELINE, device="cpu")
        plain = fe.run_steps(cam, prep.fp, prep.steps)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = fe.run_steps(cam, prep.fp, prep.steps)
    finally:
        torch.set_num_threads(threads)
    cpu = torch.autograd.DeviceType.CPU
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events() if e.device_type == cpu),
                    key=lambda ev: (ev[1], -ev[2]))
    return plain, traced, events


def _inside(events, outer):
    """The events that start inside ``outer``'s interval, ``outer`` left
    out."""
    _, s0, e0 = outer
    return [ev for ev in events if ev is not outer and s0 <= ev[1] < e0]


def test_each_range_once_a_step_in_step_order(runs):
    _, _, events = runs
    seen = [name for name, _, _ in events if name in STEP]
    assert seen == STEP * STEPS


def test_stage_and_merge_hold_no_torch_op(runs):
    _, _, events = runs
    spans = [ev for ev in events if ev[0] in HOST_ONLY]
    assert len(spans) == 4 * STEPS
    for span in spans:
        assert _inside(events, span) == [], span[0]
    # the two sites of a phase in one step are back to back: no op
    # starts between them
    names = [ev[0] for ev in events]
    for phase in HOST_ONLY:
        at = [i for i, name in enumerate(names) if name == phase]
        assert [j - i for i, j in zip(at[::2], at[1::2])] == [1] * STEPS


def test_no_frontend_or_detector_range_inside_the_cnns(runs):
    _, _, events = runs
    cnn = [ev for ev in events if ev[0] in CNN]
    assert len(cnn) == 2 * STEPS
    for span in cnn:
        inner = [ev[0] for ev in _inside(events, span)
                 if ev[0].startswith(("frontend/", "detector/"))]
        assert inner == [], (span[0], inner)


def test_outputs_bit_equal_with_and_without_the_profiler(runs):
    plain, traced, _ = runs
    kfs_a, kfs_b = plain[0], traced[0]
    assert len(kfs_a) == len(kfs_b) == DRONES * STEPS
    for a, b in zip(kfs_a, kfs_b):
        assert (a.drone_id, a.frame_id, a.t) == (b.drone_id, b.frame_id, b.t)
        for field in ("pose", "global_desc", "kp_xy", "landmarks_3d",
                      "local_desc", "valid"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    for x, y in zip(plain[1:4], traced[1:4]):     # keypoints, top-1
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_profile_solve_labels_idle_gaps_by_the_innermost_host_op():
    from omniswarm_torch.profile_solve import _idle_by_host

    kernels = [(0.0, 100.0), (100.0, 120.0), (900.0, 950.0), (960.0, 970.0),
               (2000.0, 2010.0)]
    host = [("frontend/download", 90.0, 125.0), ("aten::copy_", 95.0, 124.0),
            ("frontend/merge", 130.0, 700.0),
            ("frontend/retrieval", 710.0, 1000.0),
            ("aten::to", 880.0, 965.0)]
    assert _idle_by_host(kernels, host) == [
        ("host between ops", 1030.0), ("frontend/merge", 780.0),
        ("aten::to", 10.0)]
