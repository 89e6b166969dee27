"""The plain reference against the port's plain paths, at small sizes on
the CPU (the test imports both; the reference imports nothing of the
port), the frozen renderer against the port's, and the frozen yardstick
against hand-worked counts."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.drivers.keyframes import project
from benchmark.frozen import image_world, simulator, work
from benchmark.reference import frontend as ref

H, W = 96, 160


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def test_frozen_simulator_matches_the_port():
    from omniswarm_torch import sim

    p = dict(num_drones=3, num_frames=40, seed=9, radius_range=(2.0, 3.5),
             z_range=(0.8, 2.0))
    a = simulator.generate(simulator.SimParams(**p))
    b = sim.generate(sim.SimParams(**p))
    assert np.array_equal(a.gt, b.gt) and np.array_equal(a.vio, b.vio)


def test_frozen_renderer_matches_the_port():
    """The device renderer's images against the port's host renderer, both
    without pixel noise, for every view of a rig."""
    from omniswarm_torch.sim import image_world as port
    from omniswarm_torch.swarm.loop_cam import CameraIntrinsics

    gt = np.array([[[1.0, 0.5, 1.2, 0.3], [-2.0, 1.0, 1.0, -2.0]]])
    poses = image_world.rig_poses(gt, [0], 0.2)
    ours = image_world.RoomWorld(half=6.0, seed=5)
    theirs = port.RoomWorld(half=6.0, seed=5)
    intr = CameraIntrinsics(110.0, 110.0, W / 2, H / 2)
    for d in range(2):
        for v in range(4):
            got = ours.render(torch.from_numpy(poses[0, d, v]), 110.0,
                              110.0, H, W).numpy()
            for side in range(2):
                want = theirs.render(poses[0, d, v, side], intr, H, W)
                assert np.abs(got[side] - want).max() < 1e-4, (d, v, side)


@pytest.fixture(scope="module")
def views():
    data = simulator.generate(simulator.SimParams(
        num_drones=1, num_frames=2, seed=3, radius_range=(2.0, 3.5),
        z_range=(0.8, 2.0)))
    pairs = image_world.render_steps(
        data.gt, [0], 220.0, 220.0, H, W, 0.2,
        image_world.RoomWorld(half=6.0, seed=11), 0, "cpu")[0][0]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def test_cnns_match_the_program(views):
    from omniswarm_torch.models.netvlad import pretrained_global_extractor
    from omniswarm_torch.models.superpoint import (DEFAULT_WEIGHTS,
                                                   pretrained_extractor)
    from omniswarm_torch.models.netvlad import DEFAULT_WEIGHTS as NV

    lefts, _ = views
    img = torch.from_numpy(lefts)[:, None].float() / 255.0
    sp = ref.load_weights(DEFAULT_WEIGHTS, "cpu")
    nv = ref.load_weights(NV, "cpu")
    heat, dmap = ref.superpoint(sp, img)
    prog = pretrained_extractor("cpu")
    with torch.no_grad():
        heat_p, dmap_p = prog.net(img)
        gd_p = pretrained_global_extractor("cpu")(img)
    assert torch.allclose(heat, heat_p, atol=1e-6, rtol=1e-5)
    assert torch.allclose(dmap, dmap_p, atol=1e-6, rtol=1e-5)
    assert torch.allclose(ref.netvlad(nv, img), gd_p, atol=1e-6, rtol=1e-5)


def test_keyframe_step_matches_the_program(views):
    from omniswarm_torch.config import FrontendParams
    from omniswarm_torch.models.netvlad import DEFAULT_WEIGHTS as NV
    from omniswarm_torch.models.superpoint import DEFAULT_WEIGHTS
    from omniswarm_torch.swarm.loop_cam import CameraIntrinsics, LoopCam

    lefts, rights = views
    fp = FrontendParams(width=W, height=H)
    cam = LoopCam(params=fp, intrinsics=CameraIntrinsics(220, 220, W / 2,
                                                         H / 2),
                  baseline=0.2, device="cpu")
    xy, desc, gdesc, pts, ok = cam.extract_stereo_batch(lefts, rights)
    fe = dict(max_keypoints=fp.max_keypoints, nms_dist=fp.nms_dist,
              superpoint_thres=fp.superpoint_thres, fx=220, fy=220,
              baseline_m=0.2, triangulate_max_err=fp.triangulate_max_err)
    out = ref.step(ref.load_weights(DEFAULT_WEIGHTS, "cpu"),
                   ref.load_weights(NV, "cpu"), fe, lefts, rights, "cpu")
    valid = cam.last_kp_valid
    assert np.array_equal(valid, out.kp_valid) and valid.sum() > 100
    # slots past the valid keypoints hold centroids of zero-score pixels
    assert np.array_equal(xy[valid], out.xy.astype(np.float32)[valid])
    assert np.array_equal(ok, out.ok) and ok.sum() > 20
    # landmarks leave the card in float16: one spacing apart, at most
    # a tenth of a pixel where they project
    fe.update(width=W, height=H)
    gap = np.abs(project(pts[ok], fe) - project(out.pts[ok], fe)).max()
    assert gap < 0.1, gap
    assert np.abs(desc - out.desc.astype(np.float32)).max() <= 2 ** -10


def test_top1_matches_the_program():
    from omniswarm_torch.ops.frontend_kernels import retrieval_top1_ref

    g = torch.Generator().manual_seed(0)
    db = torch.randn(300, 64, generator=g)
    q = torch.cat([torch.randn(3, 64, generator=g), db[7:8]])
    mask = torch.rand(4, 300, generator=g) > 0.3
    mask[3, 7] = True
    a = ref.top1(db, mask, q)
    b = retrieval_top1_ref(db, q, mask)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_frozen_counts():
    assert work.conv_flops(4, 5, 3, 7, 3) == 2 * 4 * 5 * 7 * 3 * 9
    assert work.conv_flops(4, 5, 8, 8, 3, groups=8) == 2 * 4 * 5 * 8 * 9
    # SuperPoint at 208 x 400, layer by layer (2 FLOPs a multiply-add)
    full, half, quarter, eighth = 83200, 20800, 5200, 1300
    sp = 2 * 9 * (full * (1 * 64 + 64 * 64) + half * 2 * 64 * 64
                  + quarter * (64 * 128 + 128 * 128)
                  + eighth * 2 * 128 * 128 + eighth * 2 * 128 * 256)
    sp += 2 * eighth * (256 * 65 + 256 * 256)
    assert work.superpoint_flops(208, 400) == sp == 14_111_385_600
    # MobileNetVLAD v2: stem, then depthwise + pointwise blocks
    s2, s4, s8, s16 = 104 * 200, 52 * 100, 26 * 50, 13 * 25
    nv = 2 * 9 * 32 * s2
    for cin, cout, n in ((32, 64, s2), (64, 128, s4), (128, 128, s4),
                         (128, 256, s8), (256, 256, s8), (256, 512, s16),
                         (512, 512, s16)):
        nv += 2 * n * (9 * cin + cin * cout)
    assert work.mobilenetvlad_v2_flops(208, 400) == nv
    assert work.keyframe_step_flops(10, 208, 400) == 80 * sp + 40 * nv
    # K2 at 80 views of 208 x 400: f32 in and out; K3's DB at 4096 x 4096
    assert work.bound(2 * 80 * 208 * 400 * 4, 0) == pytest.approx(15.895e-6,
                                                                   rel=1e-3)
    assert work.bound(4096 * 4096 * 4, 0) == pytest.approx(20.03e-6,
                                                           rel=1e-3)
