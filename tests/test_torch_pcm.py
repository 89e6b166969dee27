"""The port's PCM and max-clique library against the JAX package's.

``tests/test_pcm.py``'s outlier scene (4 drones x 40 frames, seed 11, a
quarter of the loops outliers of magnitude 4) goes through both packages'
consistency matrices, masks and verdicts. The reference pads the loop set to
a power of two and the frames to a multiple of 64 and moves a bit-packed
mask; the port does neither, and the verdicts must still be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.robust import pcm as tpcm
from omniswarm_torch.runtime import native as tnative
from omniswarm_tpu import sim
from omniswarm_tpu.robust import pcm as jpcm
from omniswarm_tpu.runtime import native as jnative

torch.set_num_threads(1)
THRES = 2.0


@pytest.fixture(scope="module")
def scene():
    data = sim.generate(sim.SimParams(
        num_drones=4, num_frames=40, seed=11, loop_outlier_rate=0.25,
        loop_outlier_mag=4.0, loop_every=2))
    jl = jpcm.loopset_from_measurements(data.loops)
    tl = tpcm.loopset_from_measurements(data.loops)
    return data, jl, tl


def test_loopset_from_measurements(scene):
    _, jl, tl = scene
    for name in jpcm.LoopSet._fields:
        np.testing.assert_allclose(getattr(tl, name), getattr(jl, name),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        assert getattr(tl, name).dtype == getattr(jl, name).dtype


def _inputs(loops, vio):
    cum = tpcm._cumlen(np.asarray(vio, np.float32))
    return (loops.frame_a, loops.drone_a, loops.frame_b, loops.drone_b,
            loops.dpose, loops.cov_diag, np.asarray(vio, np.float32), cum)


def test_consistency_matrix(scene):
    data, jl, tl = scene
    args = _inputs(jl, data.vio)
    smd_j, same_j = jpcm.consistency_matrix(*(jnp.asarray(a) for a in args))
    smd_t, same_t = tpcm.consistency_matrix(
        *tpcm._device_inputs(tl, np.arange(len(data.loops)),
                             args[6], args[7], torch.device("cpu")))
    np.testing.assert_allclose(smd_t.numpy(), np.asarray(smd_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(same_t.numpy(), np.asarray(same_j))
    assert smd_t.dtype == torch.float32


def test_consistency_mask(scene):
    data, jl, tl = scene
    args = _inputs(jl, data.vio)
    n = len(data.loops)
    want = np.asarray(jpcm.consistency_mask(
        *(jnp.asarray(a) for a in args[:6]), jnp.ones(n, bool),
        *(jnp.asarray(a) for a in args[6:]), jnp.float32(THRES)))
    got = tpcm.consistency_mask(
        *tpcm._device_inputs(tl, np.arange(n), args[6], args[7],
                             torch.device("cpu")), THRES)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got.good_mask, want.good_mask)
    assert sorted(got.pair_inliers) == sorted(want.pair_inliers)
    for pair, idx in want.pair_inliers.items():
        np.testing.assert_array_equal(got.pair_inliers[pair], idx)


@pytest.mark.parametrize("mode", ["redundant", "self0", "self0_external",
                                  "self2"])
def test_pcm_filter_verdicts(scene, mode):
    data, jl, tl = scene
    kw = dict(pcm_thres=THRES)
    if mode != "redundant":
        kw.update(self_id=int(mode[4]), redundant=False)
    if mode == "self0_external":
        full = jpcm.pcm_filter(jl, data.vio, pcm_thres=THRES)
        kw["external_inliers"] = full.pair_inliers
    want = jpcm.pcm_filter(jl, data.vio, return_smd=False, **kw)
    got = tpcm.pcm_filter(tl, data.vio, device="cpu", return_smd=False, **kw)
    _assert_result_equal(got, want)
    assert got.smd is None
    if mode == "redundant":
        labels = np.array([lp.is_outlier for lp in data.loops])
        assert (~got.good_mask & labels).sum() > 0.8 * labels.sum()


def test_pcm_filter_return_smd(scene):
    data, jl, tl = scene
    want = jpcm.pcm_filter(jl, data.vio, pcm_thres=THRES)
    got = tpcm.pcm_filter(tl, data.vio, pcm_thres=THRES, device="cpu")
    _assert_result_equal(got, want)
    np.testing.assert_allclose(got.smd, want.smd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [None, 1, 7])
def test_launch_finish_verdicts(scene, n):
    """The async pass (launch enqueues the mask, finish runs the cliques)
    against the reference's, on the whole set, one loop and a subset."""
    data, jl, tl = scene
    rows = np.arange(len(data.loops) if n is None else n)
    jsub = jpcm.LoopSet(*(np.asarray(x)[rows] for x in jl))
    tsub = tpcm.LoopSet(*(np.asarray(x)[rows] for x in tl))
    want = jpcm.pcm_finish_all(jpcm.pcm_launch_all(
        jsub, data.vio, pcm_thres=THRES))
    handle = tpcm.pcm_launch_all(tsub, data.vio, device="cpu",
                                 pcm_thres=THRES)
    assert isinstance(handle["mask"], torch.Tensor)
    _assert_result_equal(tpcm.pcm_finish_all(handle), want)


def test_pcm_filter_empty():
    empty = tpcm.LoopSet(*(np.zeros((0,) + s, d) for s, d in (
        ((), np.int32),) * 4 + (((4,), np.float32),) * 2))
    res = tpcm.pcm_filter(empty, np.zeros((3, 2, 4)), device="cpu")
    assert res.good_mask.shape == (0,) and res.pair_inliers == {}


def _random_graph(rng, n, density, planted):
    adj = rng.uniform(size=(n, n)) < density
    idx = rng.choice(n, size=min(planted, n), replace=False)
    adj[np.ix_(idx, idx)] = True
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    return adj


@pytest.mark.parametrize("n,density,planted,seed", [
    (1, 0.0, 1, 0), (2, 0.0, 0, 1), (12, 0.3, 5, 2), (40, 0.1, 9, 3),
    (60, 0.3, 12, 4), (200, 0.05, 30, 5), (333, 0.5, 40, 6)])
def test_max_clique_matches_reference(n, density, planted, seed):
    adj = _random_graph(np.random.default_rng(seed), n, density, planted)
    got = tnative.max_clique(adj)
    np.testing.assert_array_equal(got, jnative.max_clique(adj))
    assert got.dtype == np.int64
    for i in got:
        for j in got:
            assert i == j or adj[i, j]


def test_max_clique_numpy_matches_reference():
    adj = _random_graph(np.random.default_rng(7), 50, 0.3, 10)
    np.testing.assert_array_equal(tnative._max_clique_numpy(adj),
                                  jnative._max_clique_numpy(adj))


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/bin/g++"])
def test_failed_build_raises(monkeypatch, tmp_path, cxx):
    """A compiler that fails or is missing raises; no greedy fallback."""
    monkeypatch.setattr(tnative, "CXX", cxx)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="maxclique|compiler"):
        tnative.max_clique(np.ones((3, 3), bool))
    assert not list((tmp_path / "native").glob("*.so"))
