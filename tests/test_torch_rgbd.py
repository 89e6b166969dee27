"""The batched RGB-D keyframe path (``LoopCam.on_depth_frames_batch``, the
upstream PINHOLE_DEPTH keyframes) on the CPU at small sizes, on frames of
the benchmark's RGB-D renderer (an infrared view and a uint16 millimetre
depth map with noise and holes a drone):

- the batch equals ``on_depth_frame`` called frame by frame, bit for bit;
- float-metre and uint16-millimetre depth maps of the same depths give
  the same keyframes;
- holes and depths outside (0.3, 10) m drop their landmarks, and the
  camera's counters count the lookups and the drops;
- the four host-phase ranges and ``frontend/depth_lift`` appear under
  ``torch.profiler``, the host-only ones holding no torch op;
- the port against the plain reference ``benchmark/reference/rgbd.py`` on
  seeded random SuperPoint and NetVLAD checkpoints, at 2 drones x 96 x 128
  here and at 640 x 480 on a card (marked ``cuda``; it skips here), where
  the batch launches C1 9 times, E1 12 times and K2 once and runs no plain
  kernel version.

The file imports no JAX, so it also runs on a card without it:
``python -m pytest --noconftest tests/test_torch_rgbd.py -m cuda``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.frozen import depth_world, image_world, simulator
from benchmark.reference import frontend as ref
from benchmark.reference import rgbd as ref_rgbd
from omniswarm_torch.config import FrontendParams
from omniswarm_torch.models.netvlad import init_mobilenetvlad, save_netvlad_npz
from omniswarm_torch.models.superpoint import init_superpoint, save_flax_npz
from omniswarm_torch.ops import frontend_kernels as fk
from omniswarm_torch.swarm.loop_cam import CameraIntrinsics, LoopCam

torch.set_num_threads(1)

H, W, FX = 96, 128, 77.0
SENSOR = {"noise_per_m2": 0.004, "hole_share": 0.1, "hole_block": 8}
HOST_RANGES = ("frontend/stage", "frontend/upload", "frontend/download",
               "frontend/merge")
FIELDS = ("pose", "global_desc", "kp_xy", "landmarks_3d", "local_desc",
          "valid")


def frames(drones: int, h: int = H, w: int = W, fx: float = FX, seed=4,
           device="cpu"):
    """One step of every drone's (infrared uint8, depth uint16 mm)."""
    sim = simulator.generate(simulator.SimParams(
        num_drones=drones, num_frames=1, seed=seed, radius_range=(2.0, 3.5),
        z_range=(0.8, 2.0)))
    world = image_world.RoomWorld(half=6.0, seed=seed)
    [step] = depth_world.render_rgbd(sim.gt, [0], fx, fx, h, w, world,
                                     SENSOR, seed, device)
    return sim.vio[0], step


def entries(vio, step):
    return [(d, 10, 5.0, vio[d], g, z) for d, (g, z) in enumerate(step)]


def make_cam(h=H, w=W, fx=FX, device="cpu", **weights):
    return LoopCam(params=FrontendParams(height=h, width=w),
                   intrinsics=CameraIntrinsics(fx, fx, w / 2, h / 2),
                   device=device, **weights)


@pytest.fixture(scope="module")
def cam():
    return make_cam()


@pytest.fixture(scope="module")
def three():
    return entries(*frames(3))


def _equal(a, b):
    assert (a.drone_id, a.frame_id, a.t) == (b.drone_id, b.frame_id, b.t)
    for field in FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_batch_bit_equal_to_frame_by_frame(cam, three):
    batch = cam.on_depth_frames_batch(three)
    assert len(batch) == 3
    for kf, e in zip(batch, three):
        _equal(kf, cam.on_depth_frame(*e))
        assert kf.kp_xy.dtype == kf.landmarks_3d.dtype == np.float32
        assert kf.valid.dtype == bool and kf.valid.sum() > 10


def test_float_metres_and_uint16_millimetres_agree(cam, three):
    """The device scales z16 depths by ``depth_scale`` in float32: float
    metres of the same product give the same keyframes, bit for bit; a
    depth scale of 2 mm a unit doubles every landmark."""
    metres = [e[:5] + (e[5].astype(np.float32) * np.float32(1e-3),)
              for e in three]
    for a, b in zip(cam.on_depth_frames_batch(three),
                    cam.on_depth_frames_batch(metres)):
        _equal(a, b)
    near = [e[:5] + (e[5] // 4,) for e in three]    # stays above 0.3 m
    ones = cam.on_depth_frames_batch(near)
    twos = cam.on_depth_frames_batch(near, depth_scale=2e-3)
    for a, b in zip(ones, twos):
        both = a.valid & b.valid
        assert both.sum() > 10
        np.testing.assert_allclose(b.landmarks_3d[both],
                                   2 * a.landmarks_3d[both], rtol=1e-6)


def test_holes_and_range_gated_and_counted(three):
    """Depth 0 (a hole), 0.3 m and below, 10 m and above drop a landmark;
    the counters add up every valid keypoint looked up and every drop."""
    cam = make_cam()
    gray = three[0][4]
    rows = np.arange(H)[:, None] * np.ones((1, W))
    # bands of 0 (hole), 0.3 m, 0.31 m, 5 m, 9.99 m, 10 m, 12 m
    bands = np.array([0, 300, 310, 5000, 9990, 10000, 12000], np.uint16)
    depth = bands[(rows * len(bands) // H).astype(int)]
    kf = cam.on_depth_frame(0, 1, 0.0, np.zeros(4), gray, depth)
    valid = cam.last_kp_valid[0]
    y = np.clip(np.round(kf.kp_xy[:, 1]).astype(int), 0, H - 1)
    z = depth[y, 0]
    want = valid & (z > 300) & (z < 10000)
    assert np.array_equal(kf.valid, want)
    assert want.sum() > 0 and (valid & ~want).sum() > 0
    assert not kf.landmarks_3d[~kf.valid].any()
    # body x is the camera-frame depth
    np.testing.assert_allclose(kf.landmarks_3d[kf.valid, 0],
                               z[kf.valid] * np.float32(1e-3), rtol=1e-6)
    assert (cam.depth_lookups, cam.depth_rejected) == (
        int(valid.sum()), int((valid & ~want).sum()))
    cam.on_depth_frame(0, 2, 0.0, np.zeros(4), gray, depth)
    assert (cam.depth_lookups, cam.depth_rejected) == (
        2 * int(valid.sum()), 2 * int((valid & ~want).sum()))


def test_ranges_under_the_profiler(cam, three):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = cam.on_depth_frames_batch(three)
    for a, b in zip(cam.on_depth_frames_batch(three), traced):
        _equal(a, b)
    cpu = torch.autograd.DeviceType.CPU
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events() if e.device_type == cpu),
                    key=lambda ev: (ev[1], -ev[2]))
    names = [name for name, _, _ in events]
    order = [n for n in names if n in HOST_RANGES + ("frontend/depth_lift",
                                                     "frontend/netvlad")]
    assert order == ["frontend/stage", "frontend/upload", "frontend/netvlad",
                     "frontend/depth_lift", "frontend/download",
                     "frontend/merge"]
    for span in events:
        if span[0] in ("frontend/stage", "frontend/merge"):
            inside = [ev for ev in events
                      if ev is not span and span[1] <= ev[1] < span[2]]
            assert inside == [], span[0]
    lift = next(ev for ev in events if ev[0] == "frontend/depth_lift")
    assert any(ev[0].startswith("aten::") and lift[1] <= ev[1] < lift[2]
               for ev in events)


def random_checkpoints(tmp_path, seed: int):
    """Seeded random SuperPoint (with a random orthonormal PCA) and
    MobileNetVLAD v2 checkpoints in the bundled files' layout."""
    gen = torch.Generator().manual_seed(seed)
    params = dict(init_superpoint(gen).state_dict())
    q, _ = torch.linalg.qr(torch.randn(256, 64, generator=gen))
    params["pca_components"] = q.T.contiguous()
    params["pca_mean"] = 0.01 * torch.randn(256, generator=gen)
    sp, nv = tmp_path / "sp.npz", tmp_path / "nv.npz"
    save_flax_npz(params, sp)
    save_netvlad_npz(init_mobilenetvlad(gen, 2).state_dict(), nv,
                     encoder_version=2)
    return sp, nv


def kernel_counts():
    """Launches of C1, E1 and K2, and calls of their plain versions."""
    return [fk.conv3x3.launches, fk.conv_epilogue.launches,
            fk.grid_nms.launches,
            fk.conv3x3_ref.calls + fk.conv_epilogue_ref.calls
            + fk.grid_nms_ref.calls]


@pytest.mark.parametrize("where", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_port_matches_the_plain_reference(tmp_path, where):
    """2 drones on seeded random weights, the port against the reference
    in float32 (TF32 off). Tolerances:

    - the same keypoints: every valid keypoint of either side has one of
      the other's within 1e-3 px (both compute the same f32 heat map
      with the same suppression; they differ by rounding, 1e-5 px);
    - local and global descriptors within 2e-5 (unit f32 vectors: a few
      ulps of rounding through the CNNs, the PCA and the norms);
    - the same landmarks lifted, each within 1e-5 of its range: the port
      lifts along a unit ray scaled by z / ray_z, the reference multiplies
      the pinhole ray by z, a few f32 ulps apart.
    """
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, w, fx = (H, W, FX) if where == "cpu" else (480, 640, 385.0)
    sp, nv = random_checkpoints(tmp_path, 21)
    vio, step = frames(2, h, w, fx, seed=8, device=where)
    cam = make_cam(h, w, fx, where, superpoint_weights=sp,
                   netvlad_weights=nv)
    before = kernel_counts()
    kfs = cam.on_depth_frames_batch(entries(vio, step))
    kp_valid = cam.last_kp_valid
    if where == "cuda":
        # one SuperPoint forward on the kernels and none on a plain version:
        # C1 at its nine 3 x 3 convolutions, E1 at its 12 epilogues, K2 once
        assert [a - b for a, b in zip(kernel_counts(), before)] == [
            9, 12, 1, 0]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fp = dict(max_keypoints=200, nms_dist=4, superpoint_thres=0.012,
                  fx=fx, fy=fx, cx=w / 2, cy=h / 2)
        r = ref_rgbd.step(ref.load_weights(sp, where),
                          ref.load_weights(nv, where), fp,
                          np.stack([g for g, _ in step]),
                          np.stack([z for _, z in step]), where)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for d, kf in enumerate(kfs):
        pv, rv = kp_valid[d], r.kp_valid[d]
        assert pv.sum() > 20
        dist = np.linalg.norm(kf.kp_xy[:, None] - r.xy[d][None], axis=-1)
        dist[~pv] = np.inf
        dist[:, ~rv] = np.inf
        assert (dist.min(1)[pv] < 1e-3).all()
        assert (dist.min(0)[rv] < 1e-3).all()
        pi = np.flatnonzero(pv)
        ri = dist[pi].argmin(1)
        np.testing.assert_allclose(kf.local_desc[pi], r.desc[d][ri],
                                   atol=2e-5)
        np.testing.assert_allclose(kf.global_desc, r.gdesc[d], atol=2e-5)
        assert np.array_equal(kf.valid[pi], r.ok[d][ri])
        lifted = kf.valid[pi]
        assert lifted.sum() > 10 and kf.valid.sum() == r.ok[d].sum()
        want = r.pts[d][ri][lifted]
        np.testing.assert_allclose(
            kf.landmarks_3d[pi][lifted], want,
            atol=1e-5 * float(np.abs(want).max()))
