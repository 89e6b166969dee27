"""The stereo batch's one packed download and its host merge, against the
six-download merge they replace, re-stated below in plain numpy: six
``.cpu().numpy()`` copies of ``LoopCam._extract_device``'s float16 tuple,
float16 -> float32 casts on the host, and a per-drone merge that scans for
each drone's views, turns each view's landmarks by its yaw and concatenates
them. Every array of ``extract_stereo_batch``, ``on_stereo_frame`` and
``on_fisheye_frames_batch`` must equal the re-statement's in value, dtype
and shape, on the same device tuple.

On the CPU: 2 drones x 4 directions of 96 x 160 views, uint8 and float,
with every view, with one direction left out, with other yaws, and one
stereo pair through ``on_stereo_frame``; and the arrays a caller keeps
for a whole window of steps (``landmarks_3d``, ``valid``,
``global_desc``; the keyframe benchmark keeps them) must not pin the
step's download. On a card (marked
``cuda``; it skips here): a batch of 40 pairs at 208 x 400 copies to the
host once, inside ``frontend/download``, and is bit-equal as above.

The file imports no JAX, so it also runs on a card without it:
``python -m pytest --noconftest tests/test_torch_stereo_merge.py -m cuda``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from omniswarm_torch import frontend_entry as fe
from omniswarm_torch.swarm.loop_cam import OmniLoopCam

torch.set_num_threads(2)

FIELDS = ("pose", "global_desc", "kp_xy", "landmarks_3d", "local_desc",
          "valid")
# the cases' views and yaws; None leaves a drone's direction out
CASES = {
    "all_views": (None, None),
    "one_pair_left_out": ((1, 2), None),
    "other_yaws": (None, (0.3, 1.9, -2.8, -1.1)),
}


# ---- the six-download merge, as it was written before the packing ----

def plain_extract(out):
    """``extract_stereo_batch`` on ``_extract_device``'s tuple: (the five
    arrays, the keypoint validity)."""
    xy, desc, gdesc, pts_body, ok, kp_valid = (t.cpu().numpy() for t in out)
    gdesc = gdesc.astype(np.float32)
    gdesc = gdesc / np.maximum(
        np.linalg.norm(gdesc, axis=-1, keepdims=True), 1e-8)
    return (xy.astype(np.float32), desc.astype(np.float32), gdesc,
            pts_body.astype(np.float32), ok.astype(bool)), kp_valid


def plain_yaw(yaw, pts):
    c, s = np.cos(yaw), np.sin(yaw)
    out = pts.copy()
    out[:, 0] = c * pts[:, 0] - s * pts[:, 1]
    out[:, 1] = s * pts[:, 0] + c * pts[:, 1]
    return out


def plain_merge(entries, view_yaws, extracted):
    """``on_fisheye_frames_batch``'s merge: (drone, frame, t, pose, global
    descriptor, keypoints, landmarks, local descriptors, valid) a drone."""
    xy, desc, gdesc, pts_body, ok = extracted
    owners = [(e, v) for e, entry in enumerate(entries)
              for v, pair in enumerate(entry[4]) if pair is not None]
    out = []
    for e, (drone_id, frame_id, t, vio_pose, _pairs) in enumerate(entries):
        rows = [i for i, (eo, _v) in enumerate(owners) if eo == e]
        kp_xy = np.concatenate([xy[i] for i in rows], 0)
        lms = np.concatenate(
            [plain_yaw(view_yaws[owners[i][1]], pts_body[i]) for i in rows],
            0)
        descs = np.concatenate([desc[i] for i in rows], 0)
        valid = np.concatenate([ok[i] for i in rows], 0)
        gd = np.mean([gdesc[i] for i in rows], axis=0)
        gd = gd / max(np.linalg.norm(gd), 1e-8)
        out.append((drone_id, frame_id, t, np.asarray(vio_pose, np.float32),
                    gd.astype(np.float32), kp_xy, lms.astype(np.float32),
                    descs, valid))
    return out


# ---- helpers ----

def same(x, y):
    return (x.dtype == y.dtype and x.shape == y.shape
            and np.array_equal(x, y))


class Captured:
    """Runs a call of the camera's with its device tuple and its packed
    buffer kept (the instance's methods wrapped)."""

    def __init__(self, cam):
        self.cam, self.outs, self.packed = cam, [], []

    def __call__(self, fn, *args, **kw):
        cam = self.cam
        extract, pack = cam._extract_device, cam._pack_stereo

        def extract_kept(*a):
            self.outs.append(extract(*a))
            return self.outs[-1]

        def pack_kept(out):
            self.packed.append(pack(out))
            return self.packed[-1]

        cam._extract_device, cam._pack_stereo = extract_kept, pack_kept
        try:
            return fn(*args, **kw)
        finally:
            del cam._extract_device, cam._pack_stereo


def step_entries(prep, drones, dtype, left_out=None):
    """One keyframe step's entries; float views in [0, 1]; ``left_out``
    (drone, direction) replaced by None."""
    entries = []
    for d, (drone, frame, t, pose, pairs) in enumerate(prep.steps[0][:drones]):
        if dtype == "float":
            pairs = [(l.astype(np.float32) / np.float32(255.0),
                      r.astype(np.float32) / np.float32(255.0))
                     for l, r in pairs]
        pairs = list(pairs)
        if left_out is not None and d == left_out[0]:
            pairs[left_out[1]] = None
        entries.append((drone, frame, t, pose, pairs))
    return entries


def check_batch(entries, view_yaws, kfs, out, kp_valid):
    """The keyframes against the plain merge of the device tuple."""
    extracted, want_kp_valid = plain_extract(out)
    assert same(kp_valid, want_kp_valid)
    want = plain_merge(entries, view_yaws, extracted)
    assert len(kfs) == len(want)
    for kf, w in zip(kfs, want):
        assert (kf.drone_id, kf.frame_id, kf.t) == w[:3]
        for field, x in zip(FIELDS, w[3:]):
            assert same(getattr(kf, field), x), field
        assert kf.valid.sum() > 0


@pytest.fixture(scope="module")
def small():
    prep = fe.prepare(num_drones=2, num_frames=1, kf_every=2, height=96,
                      width=160)
    cam = OmniLoopCam(params=prep.fp, intrinsics=prep.intr,
                      baseline=fe.BASELINE, device="cpu")
    return prep, cam


@pytest.mark.parametrize("dtype", ["uint8", "float"])
@pytest.mark.parametrize("case", [*CASES, "on_stereo_frame"])
def test_bit_equal_to_the_six_download_merge(small, case, dtype):
    prep, cam = small
    run = Captured(cam)
    if case == "on_stereo_frame":
        drone, frame, t, pose, pairs = step_entries(prep, 1, dtype)[0]
        left, right = pairs[2]
        kf = run(cam.on_stereo_frame, drone, frame, t, pose, left, right)
        [out] = run.outs
        (xy, desc, gdesc, pts, ok), kp_valid = plain_extract(out)
        assert same(cam.last_kp_valid, kp_valid)
        for field, x in zip(FIELDS, (np.asarray(pose, np.float32), gdesc[0],
                                     xy[0], pts[0], desc[0], ok[0])):
            assert same(getattr(kf, field), x), field
        # the seam itself, on the same pair
        got = run(cam.extract_stereo_batch, left[None], right[None])
        for x, y in zip(got, plain_extract(run.outs[1])[0]):
            assert same(x, y)
        return
    left_out, view_yaws = CASES[case]
    entries = step_entries(prep, 2, dtype, left_out)
    kfs = run(cam.on_fisheye_frames_batch, entries, view_yaws=view_yaws)
    [out] = run.outs
    assert out[0].shape[0] == (7 if left_out else 8)
    check_batch(entries, OmniLoopCam.VIEW_YAWS if view_yaws is None
                else view_yaws, kfs, out, cam.last_kp_valid)
    if left_out:
        assert len(kfs[left_out[0]].valid) == 3 * prep.fp.max_keypoints


@pytest.mark.parametrize("case", CASES)
def test_kept_arrays_do_not_pin_the_download(small, case):
    """A caller may keep each keyframe's landmarks, validity and global
    descriptor for many steps: none of them may be a view of the step's
    packed buffer (on the CPU the download is that buffer)."""
    prep, cam = small
    run = Captured(cam)
    left_out, view_yaws = CASES[case]
    kfs = run(cam.on_fisheye_frames_batch,
              step_entries(prep, 2, "uint8", left_out), view_yaws=view_yaws)
    [packed] = run.packed
    buf = packed.numpy()
    assert packed.dtype == torch.float32 and packed.shape == (
        7 if left_out else 8, prep.fp.max_keypoints
        * (2 + prep.fp.local_desc_dim + 3 + 2) + prep.fp.global_desc_dim)
    for kf in kfs:
        for field in ("landmarks_3d", "valid", "global_desc"):
            assert not np.shares_memory(getattr(kf, field), buf), field


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_download_a_batch_on_the_card(cuda_device):
    """10 drones x 4 directions at 208 x 400, the swarm10 cell's batch:
    one device-to-host copy in the call, launched inside
    ``frontend/download``, and the keyframes bit-equal to the six-download
    merge of the same device tuple."""
    prep = fe.prepare(num_drones=10, num_frames=1, kf_every=2)
    cam = OmniLoopCam(params=prep.fp, intrinsics=prep.intr,
                      baseline=fe.BASELINE, device=cuda_device)
    entries = prep.steps[0]
    cam.on_fisheye_frames_batch(entries)                # warm
    run = Captured(cam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kfs = run(cam.on_fisheye_frames_batch, entries)
    [out] = run.outs
    assert out[0].shape[0] == 40
    events, cpu = prof.events(), torch.autograd.DeviceType.CPU
    [download] = [e.time_range for e in events if e.device_type == cpu
                  and e.name == "frontend/download"]
    copies = [e for e in events if e.device_type != cpu
              and e.name.startswith("Memcpy DtoH")]
    assert len(copies) == 1, [e.name for e in copies]
    # a pageable copy: the host waits in the download until it has landed
    [copy] = [e.time_range for e in copies]
    assert download.start <= copy.start and copy.end <= download.end
    calls = [e for e in events if e.device_type == cpu
             and e.name.startswith("cudaMemcpy")
             and download.start <= e.time_range.start < download.end]
    assert len(calls) == 1, [e.name for e in calls]
    check_batch(entries, OmniLoopCam.VIEW_YAWS, kfs, out, cam.last_kp_valid)
