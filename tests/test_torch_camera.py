"""The port's camera models against the JAX reference, and the cases of
``tests/test_camera.py``: project/lift round trips, MEI beyond 90 degrees,
the YAML loader, the bearings adapter, and the generic-camera branch of
LoopCam's fused extraction."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.ops import camera as tcam
from omniswarm_tpu.ops import camera as jcam

torch.set_num_threads(1)

MODELS = [
    ("PinholeCamera", dict(fx=460, fy=460, cx=320, cy=240, k1=-0.28,
                           k2=0.07, p1=1e-4, p2=-2e-4), 0.5),
    ("MeiCamera", dict(xi=1.9, fx=780, fy=780, cx=320, cy=240, k1=-0.1,
                       k2=0.02), 1.2),
    ("EquidistantCamera", dict(mu=230, mv=230, u0=320, v0=240, k2=0.01,
                               k3=-0.002, k4=0.0005, k5=0.0), 1.4),
]


def random_rays(rng, n, max_angle):
    ang = rng.uniform(0, max_angle, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    return np.stack([np.sin(ang) * np.cos(phi), np.sin(ang) * np.sin(phi),
                     np.cos(ang)], 1).astype(np.float32)


@pytest.mark.parametrize("name,kw,max_angle", MODELS,
                         ids=[m[0] for m in MODELS])
def test_model_matches_reference(rng, name, kw, max_angle):
    jc, tc = getattr(jcam, name)(**kw), getattr(tcam, name)(**kw)
    pts = random_rays(rng, 256, max_angle) * rng.uniform(
        1.0, 10.0, (256, 1)).astype(np.float32)
    uv_j, valid_j = jc.project(jnp.asarray(pts))
    uv_t, valid_t = tc.project(torch.from_numpy(pts))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5,
                               atol=1e-3)
    uv = np.array(uv_j)
    lift_t = tc.lift(torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(lift_t, np.asarray(jc.lift(jnp.asarray(uv))),
                               atol=1e-5)
    # the round trip of tests/test_camera.py
    assert valid_t.numpy().all()
    rays = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    assert np.linalg.norm(lift_t - rays, axis=1).max() < 1e-3


def test_mei_wide_angle_behind_camera():
    cam = tcam.MeiCamera(xi=2.0, fx=800, fy=800, cx=320, cy=240)
    ang = np.deg2rad(120.0)
    ray = np.array([[np.sin(ang), 0.0, np.cos(ang)]], np.float32)
    uv, valid = cam.project(ray * 3.0)
    assert bool(valid[0])
    assert np.linalg.norm(cam.lift(uv)[0].numpy() - ray[0]) < 1e-3


def test_equidistant_centre_ray():
    cam = tcam.EquidistantCamera(mu=230, mv=230, u0=320, v0=240, k2=0.01)
    ref = jcam.EquidistantCamera(mu=230, mv=230, u0=320, v0=240, k2=0.01)
    uv = np.array([[320.0, 240.0], [321.0, 240.0]], np.float32)
    np.testing.assert_allclose(cam.lift(uv).numpy(),
                               np.asarray(ref.lift(jnp.asarray(uv))),
                               atol=1e-6)


YAMLS = [
    {"model_type": "PINHOLE",
     "distortion_parameters": {"k1": -0.3, "k2": 0.1, "p1": 0, "p2": 0},
     "projection_parameters": {"fx": 460, "fy": 461, "cx": 320, "cy": 240}},
    {"model_type": "MEI", "mirror_parameters": {"xi": 1.85},
     "distortion_parameters": {"k1": -0.1, "k2": 0.01},
     "projection_parameters": {"gamma1": 780, "gamma2": 781, "u0": 320,
                               "v0": 240}},
    {"model_type": "KANNALA_BRANDT",
     "distortion_parameters": {"k2": 0.01, "k3": -0.002, "k4": 0.0,
                               "k5": 0.0},
     "projection_parameters": {"mu": 230, "mv": 231, "u0": 320, "v0": 240}},
]


@pytest.mark.parametrize("cfg", YAMLS, ids=[c["model_type"] for c in YAMLS])
def test_yaml_loader_matches_reference(cfg, tmp_path):
    import yaml

    path = tmp_path / "cam.yaml"
    path.write_text(yaml.safe_dump(cfg))
    for src in (cfg, str(path)):
        got, want = tcam.camera_from_yaml(src), jcam.camera_from_yaml(src)
        assert type(got).__name__ == type(want).__name__
        assert got.__dict__ == want.__dict__
    with pytest.raises(ValueError):
        tcam.camera_from_yaml({"model_type": "NOPE"})


def test_bearings_adapter_matches_lift(rng):
    cam = tcam.EquidistantCamera(mu=230, mv=230, u0=200, v0=104)
    uv, _ = cam.project(random_rays(rng, 32, 1.2) * 2.0)
    b = tcam.CameraBearings(cam).bearings(uv.numpy())
    assert b.shape == (32, 3)
    np.testing.assert_allclose(b, cam.lift(uv).numpy(), atol=1e-6)


def test_pinhole_matches_simple_intrinsics(rng):
    from omniswarm_torch.swarm.loop_cam import CameraIntrinsics

    cam = tcam.PinholeCamera(fx=200, fy=200, cx=200, cy=104)
    simple = CameraIntrinsics(fx=200, fy=200, cx=200, cy=104)
    xy = rng.uniform(0, 400, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(cam.lift(xy).numpy(), simple.bearings(xy),
                               atol=1e-5)


def test_loop_cam_generic_camera_branch(rng):
    """A LoopCam whose intrinsics carry a camera model lifts keypoints
    with it (the reference's generic-camera branch); a zero-distortion
    pinhole model gives the plain pinhole rays."""
    from omniswarm_torch.swarm.loop_cam import CameraIntrinsics, LoopCam

    mei = tcam.MeiCamera(xi=1.2, fx=300, fy=300, cx=200, cy=104, k1=-0.05)
    cam = LoopCam.__new__(LoopCam)
    cam.intr = tcam.CameraBearings(mei)
    xy = torch.from_numpy(rng.uniform(0, 400, (2, 16, 2)).astype(np.float32))
    want = jcam.MeiCamera(xi=1.2, fx=300, fy=300, cx=200, cy=104,
                          k1=-0.05).lift(jnp.asarray(xy.numpy()))
    np.testing.assert_allclose(cam._bearings(xy).numpy(), np.asarray(want),
                               atol=1e-5)
    cam.intr = tcam.CameraBearings(tcam.PinholeCamera(fx=220, fy=220,
                                                      cx=200, cy=104))
    plain = CameraIntrinsics(fx=220, fy=220, cx=200, cy=104)
    np.testing.assert_allclose(cam._bearings(xy).numpy(),
                               plain.bearings_torch(xy).numpy(), atol=1e-6)
