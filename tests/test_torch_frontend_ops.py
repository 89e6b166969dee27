"""Port vs reference: the front-end's geometric ops, the place DB, the
image world and the configuration.

Same inputs (numpy, seeded) through the JAX functions and their ports.
Tolerances: keypoint indices, scores and validity exact and xy within
1e-5 px; descriptor sampling 1e-6; matching indices and masks exact,
similarities 1e-6; triangulation within 1e-4 m relative to the range
(f32 solves of 3x3 systems); place-DB indices exact, similarities 1e-5;
rendered images bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch import config as tconfig
from omniswarm_torch.ops import keypoints as tkp
from omniswarm_torch.ops import matching as tmatch
from omniswarm_torch.ops import placedb as tpdb
from omniswarm_torch.ops import triangulation as ttri
from omniswarm_torch.sim import image_world as tiw
from omniswarm_torch.swarm import comm as tcomm
from omniswarm_torch.swarm import loop_cam as tcam
from omniswarm_tpu import config as jconfig
from omniswarm_tpu.models import train_superpoint as jts
from omniswarm_tpu.ops import keypoints as jkp
from omniswarm_tpu.ops import matching as jmatch
from omniswarm_tpu.ops import placedb as jpdb
from omniswarm_tpu.ops import triangulation as jtri
from omniswarm_tpu.sim import image_world as jiw
from omniswarm_tpu.swarm import comm as jcomm
from omniswarm_tpu.swarm import loop_cam as jcam

torch.set_num_threads(1)


def test_extract_keypoints_matches():
    rng = np.random.default_rng(1)
    heat = (rng.uniform(size=(3, 64, 96)) ** 8).astype(np.float32) * 0.2
    heat[0, :10, :10] = 0.05                       # a plateau
    heat[2] = 0.0                                  # no keypoint at all
    heat[2, 30, 50] = 0.5
    want = jax.vmap(lambda h: jkp.extract_keypoints(
        h, max_keypoints=200, threshold=0.012, nms_dist=4))(jnp.asarray(heat))
    got = tkp.extract_keypoints(torch.from_numpy(heat), max_keypoints=200,
                                threshold=0.012, nms_dist=4)
    xy_j, s_j, v_j = (np.asarray(v) for v in want)
    xy_t, s_t, v_t = (v.numpy() for v in got)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(v_t, v_j)
    assert v_t[2].sum() == 1
    # all K rows, the zero-score slots past the valid ones included
    np.testing.assert_allclose(xy_t, xy_j, rtol=0, atol=1e-5)


def test_bilinear_sample_descriptors_matches():
    rng = np.random.default_rng(2)
    desc = rng.normal(size=(2, 12, 20, 16)).astype(np.float32)
    xy = np.stack([rng.uniform(-2, 162, size=(2, 50)),
                   rng.uniform(-2, 98, size=(2, 50))], -1).astype(np.float32)
    want = np.stack([np.asarray(jkp.bilinear_sample_descriptors(
        jnp.asarray(desc[b]), jnp.asarray(xy[b]))) for b in range(2)])
    got = tkp.bilinear_sample_descriptors(torch.from_numpy(desc),
                                          torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_mutual_match_matches():
    rng = np.random.default_rng(3)
    a = _unit(rng, 2, 60, 32)
    b = a[:, rng.permutation(60)] + 0.1 * rng.normal(size=(2, 60, 32))
    b = (b / np.linalg.norm(b, axis=-1, keepdims=True)).astype(np.float32)
    va = rng.uniform(size=(2, 60)) > 0.2
    vb = rng.uniform(size=(2, 60)) > 0.2
    vb[1] = False                                  # nothing to match
    got = tmatch.mutual_match(*map(torch.from_numpy, (a, b, va, vb)),
                              min_similarity=0.5)
    for i in range(2):
        want = jmatch.mutual_match(*map(jnp.asarray, (a[i], b[i], va[i],
                                                      vb[i])),
                                   min_similarity=0.5)
        np.testing.assert_array_equal(got.idx_b[i].numpy(), want.idx_b)
        np.testing.assert_array_equal(got.mask[i].numpy(), want.mask)
        np.testing.assert_allclose(got.sim[i].numpy(), want.sim, atol=1e-6)
    assert got.mask[0].sum() > 20 and not got.mask[1].any()


def test_triangulate_stereo_matches():
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1, 1, 200),
                    rng.uniform(0.5, 20, 200)], -1)
    base = 0.2
    left = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    right = pts - [base, 0, 0]
    right = right / np.linalg.norm(right, axis=1, keepdims=True)
    left, right = left.astype(np.float32), right.astype(np.float32)
    p_j, e_j = jtri.triangulate_stereo(jnp.asarray(left), jnp.asarray(right),
                                       base)
    p_t, e_t = ttri.triangulate_stereo(torch.from_numpy(left[None]),
                                       torch.from_numpy(right[None]), base)
    p_j = np.asarray(p_j)
    rng_m = np.linalg.norm(p_j, axis=1, keepdims=True)
    np.testing.assert_allclose(p_t[0].numpy(), p_j, rtol=0,
                               atol=1e-4 * rng_m.max())
    assert (np.abs(p_t[0].numpy() - p_j) <= 1e-4 * rng_m + 1e-5).all()
    np.testing.assert_allclose(e_t[0].numpy(), np.asarray(e_j), atol=1e-4)
    np.testing.assert_allclose(p_t[0].numpy(), pts, rtol=0,
                               atol=2e-3 * rng_m.max())


def _dbs(seed, N=40, D=32, n_add=30):
    rng = np.random.default_rng(seed)
    descs = _unit(rng, n_add, D)
    drones = rng.integers(0, 3, n_add)
    frames = np.arange(n_add) // 3 * 2
    jdb = jpdb.make_placedb(N, D)
    tdb = tpdb.make_placedb(N, D, "cpu")
    for d, dr, fr in zip(descs, drones, frames):
        jdb = jpdb.add(jdb, jnp.asarray(d), jnp.asarray(dr), jnp.asarray(fr))
        tdb = tpdb.add(tdb, torch.from_numpy(d), int(dr), int(fr))
    q = descs[[4, 17, 25]] + 0.2 * rng.normal(size=(3, D))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return jdb, tdb, q, drones[[4, 17, 25]], frames[[4, 17, 25]]


def test_placedb_add_matches():
    jdb, tdb, *_ = _dbs(5, N=16)                   # 30 inserts wrap the ring
    assert tdb.cursor == int(jdb.cursor) == 30
    np.testing.assert_array_equal(tdb.desc.numpy(), np.asarray(jdb.desc))
    for name in ("drone_id", "frame_id", "valid"):
        np.testing.assert_array_equal(getattr(tdb, name).numpy(),
                                      np.asarray(getattr(jdb, name)))


@pytest.mark.parametrize("guard", [1, 4])
def test_placedb_queries_match(guard):
    jdb, tdb, q, qd, qf = _dbs(6)
    for i in range(3):
        bj, sj = jpdb.query(jdb, jnp.asarray(q[i]), jnp.asarray(qd[i]),
                            jnp.asarray(qf[i]), match_index_dist=guard)
        bt, st = tpdb.query(tdb, torch.from_numpy(q[i]), int(qd[i]),
                            int(qf[i]), match_index_dist=guard)
        assert int(bt) == int(bj)
        np.testing.assert_allclose(float(st), float(sj), atol=1e-5)
        # k = 12 runs past the 10 unused slots' -inf ties
        ij, tsj = jpdb.query_topk(jdb, jnp.asarray(q[i]), jnp.asarray(qd[i]),
                                  jnp.asarray(qf[i]), k=12,
                                  match_index_dist=guard)
        it, tst = tpdb.query_topk(tdb, torch.from_numpy(q[i]), int(qd[i]),
                                  int(qf[i]), k=12, match_index_dist=guard)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(tst.numpy(), np.asarray(tsj), atol=1e-5)
    bj, sj = jpdb.query_batch(jdb, jnp.asarray(q), jnp.asarray(qd),
                              jnp.asarray(qf), match_index_dist=guard)
    bt, st = tpdb.query_batch(tdb, torch.from_numpy(q), qd, qf,
                              match_index_dist=guard)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)


def test_placedb_query_empty_and_topk2():
    jdb, tdb, q, qd, qf = _dbs(7, N=64)
    jempty = jpdb.make_placedb(64, 32)
    tempty = tpdb.make_placedb(64, 32, "cpu")
    bt, st = tpdb.query_batch(tempty, torch.from_numpy(q), qd, qf)
    assert (bt == 0).all() and torch.isneginf(st).all()
    meta = np.asarray([qd[0], qf[0], 4, 1], np.int32)
    want = jpdb.query_topk2(jdb, jempty, jnp.asarray(q[0]), jnp.asarray(meta),
                            k=8)
    got = tpdb.query_topk2(tdb, tempty, torch.from_numpy(q[0]), meta, k=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_render_shapes_bit_identical():
    a = jts.render_shapes(np.random.default_rng(9), 64, 96, n_shapes=20)
    b = tiw.render_shapes(np.random.default_rng(9), 64, 96, n_shapes=20)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("world", ["room", "wall"])
def test_rendered_images_bit_identical(world):
    if world == "room":
        jw, tw = jiw.RoomWorld(half=6.0, seed=11), tiw.RoomWorld(half=6.0,
                                                                 seed=11)
    else:
        jw, tw = jiw.WallWorld(seed=3), tiw.WallWorld(seed=3)
    jintr = jcam.CameraIntrinsics(fx=220, fy=220, cx=80, cy=48)
    tintr = tcam.CameraIntrinsics(fx=220, fy=220, cx=80, cy=48)
    pose = np.asarray([0.5, -1.0, 1.2, 0.7])
    ja = jw.render_stereo(pose, jintr, 96, 160, 0.2,
                          rng=np.random.default_rng(0))
    ta = tw.render_stereo(pose, tintr, 96, 160, 0.2,
                          rng=np.random.default_rng(0))
    for x, y in zip(ja, ta):
        assert x.dtype == y.dtype and np.array_equal(x, y)
        assert x.std() > 0.05


def test_config_and_keyframe_copies_match():
    j, t = jconfig.FrontendParams(), tconfig.FrontendParams()
    # the whole reference dataclass: SwarmConfig.from_yaml sets any field
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    assert ([f.name for f in dataclasses.fields(jcomm.KeyframeData)]
            == [f.name for f in dataclasses.fields(tcomm.KeyframeData)])
    np.testing.assert_array_equal(tcam.CAM_TO_BODY, jcam.CAM_TO_BODY)
    xy = np.random.default_rng(1).uniform(0, 160, size=(20, 2))
    np.testing.assert_array_equal(
        tcam.CameraIntrinsics(220, 220, 80, 48).bearings(xy),
        jcam.CameraIntrinsics(220, 220, 80, 48).bearings(xy))
    pts = np.random.default_rng(2).normal(size=(10, 3))
    np.testing.assert_array_equal(tcam.yaw_rotate_np(0.3, pts),
                                  jcam.yaw_rotate_np(0.3, pts))
