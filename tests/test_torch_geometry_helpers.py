"""The port's pose helpers against ``omniswarm_tpu/core/geometry.py``, and
the package surface: every name a reference package re-exports resolves in
the port's package of the same name.

The helpers run on the inputs of ``tests/test_geometry.py`` (f32, seed 0)
and must agree with the reference within 1e-6 (relative and absolute);
the JAX side's einsums run at the highest matmul precision (JAX's default
on the CPU rounds products to bf16).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.core import geometry as tgeo
from omniswarm_tpu.core import geometry as jgeo

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-6, atol=1e-6)


def random_poses(rng, n):
    pos = rng.normal(size=(n, 3)) * 10
    yaw = rng.uniform(-np.pi, np.pi, size=(n, 1))
    return np.concatenate([pos, yaw], axis=1).astype(np.float32)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def units(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def inputs(rng):
    """Each helper's arguments (numpy, f32)."""
    poses = random_poses(rng, 128)
    pts = rng.normal(size=(128, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, size=256).astype(np.float32)
    q1, q2 = unit_quats(rng, 32), unit_quats(rng, 32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    a = rng.normal(size=(16, 4, 4)).astype(np.float32)
    cov_inv = np.einsum("nij,nkj->nik", a, a) + np.eye(4, dtype=np.float32)
    dirs = np.concatenate([units(rng, 126),
                           np.asarray([[0, 0, 1.0], [0, 0, -1.0]],
                                      np.float32)])
    return {
        "pose_position": (poses,),
        "pose_yaw": (poses,),
        "transform_point": (poses, pts),
        "inverse_transform_point": (poses, pts),
        "quat_mul": (q1, q2),
        "quat_conj": (q1,),
        "quat_rotate": (q1, v),
        "quat_from_yaw": (yaw,),
        "yaw_from_quat": (q1,),
        "pose6_to_pose4": (pts[:32], q2),
        "tangent_base_from_unit": (dirs,),
        "squared_mahalanobis": (rng.normal(size=(16, 4)).astype(np.float32),
                                cov_inv),
        "pose_error_4d": (random_poses(rng, 8), random_poses(rng, 8),
                          (np.eye(4) * 2.0 + 0.1 * rng.normal(size=(4, 4))
                           ).astype(np.float32)),
    }


HELPERS = sorted(inputs(np.random.default_rng(0)))


@pytest.mark.parametrize("name", HELPERS)
def test_helper_matches_reference(name):
    args = inputs(np.random.default_rng(0))[name]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(getattr(jgeo, name)(*(jnp.asarray(a)
                                                for a in args)))
    got = getattr(tgeo, name)(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_helper_properties():
    """tests/test_geometry.py's properties, on the port."""
    rng = np.random.default_rng(0)
    pose = torch.from_numpy(random_poses(rng, 128))
    pts = torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32))
    body = tgeo.inverse_transform_point(pose, tgeo.transform_point(pose, pts))
    np.testing.assert_allclose(body.numpy(), pts.numpy(), atol=1e-4)
    yaw = torch.from_numpy(rng.uniform(-np.pi, np.pi, 64).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    q = tgeo.quat_from_yaw(yaw)
    np.testing.assert_allclose(tgeo.yaw_from_quat(q).numpy(), yaw.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(tgeo.quat_rotate(q, v).numpy(),
                               tgeo.yaw_rotate(yaw, v).numpy(), atol=1e-4)
    q1 = torch.from_numpy(unit_quats(rng, 64))
    lhs = tgeo.quat_rotate(tgeo.quat_mul(q1, q), v)
    rhs = tgeo.quat_rotate(q1, tgeo.quat_rotate(q, v))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4)
    d = torch.from_numpy(units(rng, 128))
    tb = tgeo.tangent_base_from_unit(d)
    np.testing.assert_allclose(torch.einsum("nkj,nj->nk", tb, d).numpy(),
                               0.0, atol=1e-5)
    np.testing.assert_allclose(torch.linalg.norm(tb, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), tgeo.tangent_base_from_unit_np(
        d.numpy()), atol=1e-6)


def _reexports():
    """(package, name) for every name a reference package's __init__
    imports from its modules."""
    out = []
    for init in sorted((ROOT / "omniswarm_tpu").glob("*/__init__.py")):
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom):
                out += [(init.parent.name, a.asname or a.name)
                        for a in node.names]
    return out


def test_every_reference_export_resolves():
    import importlib

    names = _reexports()
    assert ("solver", "lm_solve") in names and len(names) > 60
    missing = [(pkg, name) for pkg, name in names
               if not hasattr(importlib.import_module(
                   f"omniswarm_torch.{pkg}"), name)]
    assert not missing
    from omniswarm_torch.solver import lm_solve  # noqa: F401
