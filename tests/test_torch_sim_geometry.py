"""Port vs reference: simulator, geometry and the dense graph build."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch import sim as tsim
from omniswarm_torch.core import geometry as tgeo
from omniswarm_torch.solver import dense as tdense
from omniswarm_tpu import sim as jsim
from omniswarm_tpu.core import geometry as jgeo
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)


def _pair(seed, F=30, D=4, **kw):
    jp = jsim.SimParams(num_drones=D, num_frames=F, seed=seed, **kw)
    tp = tsim.SimParams(num_drones=D, num_frames=F, seed=seed, **kw)
    return jsim.generate(jp), tsim.generate(tp)


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_bit_identical(seed):
    ref, got = _pair(seed, loop_outlier_rate=0.2)
    for name in ("times", "gt", "vio", "ranges", "range_valid"):
        a, b = getattr(ref, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(ref.loops) == len(got.loops) > 0
    for lr, lg in zip(ref.loops, got.loops):
        for f in dataclasses.fields(lr):
            assert np.array_equal(getattr(lr, f.name), getattr(lg, f.name))
    assert len(ref.detections) == len(got.detections) > 0
    for dr, dg in zip(ref.detections, got.detections):
        for f in dataclasses.fields(dr):
            assert np.array_equal(getattr(dr, f.name), getattr(dg, f.name))


def _poses(rng, n=64):
    p = rng.normal(size=(n, 4)) * [3.0, 3.0, 1.0, 4.0]
    return p.astype(np.float32)


@pytest.mark.parametrize("fn", ["normalize_angle", "yaw_rotate", "pose_mul",
                                "pose_inv", "delta_pose", "make_pose"])
def test_geometry_matches_jax(fn):
    rng = np.random.default_rng(3)
    a, b = _poses(rng), _poses(rng)
    if fn == "normalize_angle":
        args = (a[:, 3] * 3.0,)
    elif fn == "yaw_rotate":
        args = (a[:, 3], b[:, :3])
    elif fn == "pose_inv":
        args = (a,)
    elif fn == "make_pose":
        args = (a[:, :3], b[:, 3])
    else:
        args = (a, b)
    want = np.asarray(getattr(jgeo, fn)(*map(jnp.asarray, args)))
    got = getattr(tgeo, fn)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_tangent_base_np_identical():
    rng = np.random.default_rng(4)
    d = rng.normal(size=(50, 3))
    d[:5] = [0.0, 0.001, 1.0]                      # near-z helper branch
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    assert np.array_equal(tgeo.tangent_base_from_unit_np(d),
                          jgeo.tangent_base_from_unit_np(d))


@pytest.mark.parametrize("ant", [False, True])
def test_dense_graph_from_sim_matches(ant):
    ref, got = _pair(31, F=20, D=4)
    ant_pos = (np.random.default_rng(5).normal(size=(4, 3)) * 0.1
               if ant else None)
    jg = jdense.dense_graph_from_sim(ref, ant_pos=ant_pos)
    tg = tdense.dense_graph_from_sim(got, ant_pos=ant_pos)
    for name in jdense.DenseGraph._fields:
        a, b = getattr(jg, name), getattr(tg, name)
        if name == "loops":
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), np.asarray(y))
        elif a is None:
            assert b is None, name
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
