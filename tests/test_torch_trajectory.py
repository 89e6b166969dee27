"""The port's ring-buffer trajectory and drift model against the JAX
package's (``tests/test_trajectory.py``'s checks, on both)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.core import geometry as tgeo
from omniswarm_torch.core import trajectory as ttrj
from omniswarm_tpu.core import geometry as jgeo
from omniswarm_tpu.core import trajectory as jtrj

torch.set_num_threads(1)


def line_trajs(n=10, cap=16):
    """The same straight-line trajectory in both packages."""
    jt, tt = jtrj.make_trajectory(cap), ttrj.make_trajectory(cap)
    for i in range(n):
        pose = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32) * i
        jt = jtrj.append(jt, i * 0.1, jnp.asarray(pose))
        tt = ttrj.append(tt, i * 0.1, torch.from_numpy(pose))
    return jt, tt


def assert_traj_equal(jt, tt):
    for name in jtrj.Trajectory._fields:
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n", [10, 20])
def test_append_and_ring_overwrite(n):
    jt, tt = line_trajs(n, 16)
    assert_traj_equal(jt, tt)
    assert int(tt.count) == min(n, 16)
    assert tt.capacity == 16


def test_append_leaves_input_unchanged():
    tt = ttrj.make_trajectory(4)
    t1 = ttrj.append(tt, 0.0, torch.ones(4))
    assert int(tt.count) == 0 and bool(torch.isinf(tt.ts).all())
    assert int(t1.count) == 1


@pytest.mark.parametrize("t", [0.31, 0.52, -1.0, 5.0])
def test_nearest_and_pose_at(t):
    jt, tt = line_trajs(10, 16)
    assert int(ttrj.nearest_index(tt, t)) == int(
        jtrj.nearest_index(jt, jnp.asarray(t)))
    np.testing.assert_allclose(ttrj.pose_at(tt, t).numpy(),
                               np.asarray(jtrj.pose_at(jt, jnp.asarray(t))),
                               atol=1e-6)


@pytest.mark.parametrize("t0,t1", [(0.2, 0.7), (0.7, 0.2), (0.0, 0.9)])
def test_length_between(t0, t1):
    jt, tt = line_trajs(10, 16)
    np.testing.assert_allclose(
        float(ttrj.length_between(tt, t0, t1)),
        float(jtrj.length_between(jt, jnp.asarray(t0), jnp.asarray(t1))),
        atol=1e-5)


def test_relative_pose_between_matches_delta():
    p0 = np.asarray([1.0, 2.0, 0.5, 0.3], np.float32)
    p1 = np.asarray([2.0, 1.0, 0.7, -0.4], np.float32)
    jt = jtrj.append(jtrj.append(jtrj.make_trajectory(8), 0.0,
                                 jnp.asarray(p0)), 1.0, jnp.asarray(p1))
    tt = ttrj.append(ttrj.append(ttrj.make_trajectory(8), 0.0,
                                 torch.from_numpy(p0)), 1.0,
                     torch.from_numpy(p1))
    rel = ttrj.relative_pose_between(tt, 0.0, 1.0).numpy()
    np.testing.assert_allclose(
        rel, np.asarray(jtrj.relative_pose_between(
            jt, jnp.asarray(0.0), jnp.asarray(1.0))), atol=1e-6)
    np.testing.assert_allclose(
        rel, tgeo.delta_pose(torch.from_numpy(p0),
                             torch.from_numpy(p1)).numpy(), atol=1e-6)


def test_drift_covariance_between():
    jt, tt = line_trajs(10, 16)
    kw = dict(cov_pos_per_meter=0.002, cov_yaw_per_meter=1e-4)
    np.testing.assert_allclose(
        ttrj.drift_covariance_between(tt, 0.0, 0.5, **kw).numpy(),
        np.asarray(jtrj.drift_covariance_between(
            jt, jnp.asarray(0.0), jnp.asarray(0.5), **kw)), rtol=1e-6)


@pytest.mark.parametrize("length", [0.0, 2.5, np.array([0.0, 1e-4, 3.0]),
                                    "tensor"])
def test_drift_variances(length):
    want = jtrj.drift_variances(
        np.array([0.5, 7.0]) if isinstance(length, str) else length,
        0.002, 1e-4)
    got = ttrj.drift_variances(
        torch.tensor([0.5, 7.0]) if isinstance(length, str) else length,
        0.002, 1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)


def test_path_length_np():
    rng = np.random.default_rng(3)
    ts = np.sort(rng.uniform(0, 10, 30))
    pos = np.cumsum(rng.normal(size=(30, 3)), 0)
    for t0, t1 in ((0.0, 10.0), (2.2, 7.9), (5.0, 5.0)):
        assert ttrj.path_length_np(ts, pos, t0, t1) == \
            jtrj.path_length_np(ts, pos, t0, t1)
    assert ttrj.path_length_np(np.zeros(0), np.zeros((0, 3)), 0, 1) == 0.0


def test_se3_helpers_match_reference():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.normal(size=(6, 3)),
                        jgeo.quat_from_rpy_np(*rng.normal(size=(3, 6)))], -1)
    b = np.concatenate([rng.normal(size=(6, 3)),
                        jgeo.quat_from_rpy_np(*rng.normal(size=(3, 6)))], -1)
    for name in ("se3_mul_np", "se3_delta_np"):
        np.testing.assert_array_equal(getattr(tgeo, name)(a, b),
                                      getattr(jgeo, name)(a, b))
    for name in ("se3_inv_np", "se3_to_pose4_np", "yaw_from_quat_np"):
        arg = a[..., 3:] if name == "yaw_from_quat_np" else a
        np.testing.assert_array_equal(getattr(tgeo, name)(arg),
                                      getattr(jgeo, name)(arg))
    p4 = rng.normal(size=(6, 4))
    np.testing.assert_array_equal(tgeo.pose4_to_se3_np(p4),
                                  jgeo.pose4_to_se3_np(p4))
    back = tgeo.se3_to_pose4_np(tgeo.pose4_to_se3_np(p4))
    np.testing.assert_allclose(back[:, :3], p4[:, :3], atol=1e-12)
    np.testing.assert_allclose(np.exp(1j * back[:, 3]), np.exp(1j * p4[:, 3]),
                               atol=1e-12)
