"""Port vs reference: the SuperPoint training path.

The same ``np.random.Generator`` seeds and the same (converted) bundled
weights go through ``omniswarm_tpu/models/train_superpoint.py`` and
``omniswarm_torch/models/train_superpoint.py`` on the CPU; the JAX side runs
under ``jax.default_matmul_precision("highest")``. Tolerances: renders,
labels and homographic-adaptation labels bit-identical; losses rtol 1e-5;
each gradient leaf's max-abs difference <= 1e-4 x its max-abs value; three
Adam steps of ``train_detector`` rtol 1e-4 per step; ``init_superpoint``'s
per-layer std within 5% of Flax's; the metrics' counts equal; checkpoints
written by either package read by the other give the same forward within
1e-5 (the f16 file's weights in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from omniswarm_torch import train_entry
from omniswarm_torch.convert import (superpoint_params_from_flax,
                                     superpoint_params_to_flax)
from omniswarm_torch.models import superpoint as tsp_model
from omniswarm_torch.models import train_superpoint as tsp
from omniswarm_tpu.models import superpoint as jsp_model
from omniswarm_tpu.models import train_superpoint as jsp

torch.set_num_threads(1)
WEIGHTS = tsp_model.WEIGHTS_DIR
H, W = 32, 48


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def synthetic():
    """(Flax params of superpoint_synthetic, the port's SuperPoint state)."""
    flax = jsp_model.load_flax_npz(WEIGHTS / "superpoint_synthetic.npz")
    return flax["net"], tsp_model.net_state(train_entry.read_superpoint(
        WEIGHTS / "superpoint_synthetic.npz"))


def _net(state):
    net = tsp_model.SuperPoint()
    net.load_state_dict(state)
    return net


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

RENDERS = {
    "render_textured": lambda m, r: m.render_textured(r, 64, 96),
    "render_textured_8": lambda m, r: m.render_textured(r, H, W, n_shapes=8),
    "render_mixed": lambda m, r: [m.render_mixed(r, H, W) for _ in range(6)],
    "make_batch": lambda m, r: m.make_batch(r, 3, 64, 96),
    "make_batch_textured": lambda m, r: m.make_batch_textured(r, 3, H, W),
    "corner_label_map": lambda m, r: m.corner_label_map(
        np.asarray([[0.4, 0.6], [47.5, 31.49], [10.5, 7.5], [-1, 3],
                    [12.2, 40.0], [3.0, 3.0]], np.float32), H, W),
    "make_warped_pairs": lambda m, r: m.make_warped_pairs(r, 3, H, W),
    "make_warped_pairs_textured": lambda m, r: m.make_warped_pairs(
        r, 2, 64, 96, max_rot=0.5, scale=(0.85, 1.2),
        render_fn=m.render_textured),
}


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _flat(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_renders_bit_identical(name):
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    want, got = _flat(RENDERS[name](jsp, rj)), _flat(RENDERS[name](tsp, rt))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert rj.uniform() == rt.uniform()        # same draws consumed


def test_homographic_adaptation_labels_bit_identical(synthetic):
    flax, state = synthetic
    imgs, _ = tsp.make_batch_textured(np.random.default_rng(2), 2, H, W)
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    want = jsp.homographic_adaptation_labels(
        jsp_model.SuperPoint(), flax, imgs, rj, n_warps=4)
    got = tsp.homographic_adaptation_labels(_net(state), imgs, rt,
                                            n_warps=4)
    assert (want < 64).sum() >= 3
    np.testing.assert_array_equal(got, want)
    assert rj.uniform() == rt.uniform()


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------

def _inputs(seed=0, shift=None):
    rng = np.random.default_rng(seed)
    imgs, labels = tsp.make_batch(rng, 2, H, W)
    ia, ib, T = tsp.make_warped_pairs(rng, 2, H, W, max_rot=0.4,
                                      scale=(0.9, 1.1))
    if shift is not None:               # pure shifts: exact argmin ties
        T = np.zeros((2, 2, 3), np.float32)
        T[:, 0, 0] = T[:, 1, 1] = 1.0
        T[:, :, 2] = shift
    return imgs, labels, ia, ib, T


def _jax_loss(kind, net, imgs, labels, ia, ib, T):
    model = jsp_model.SuperPoint()
    if kind == "detector":
        return jsp.detector_loss(net, model, imgs, labels)
    ld = jsp.descriptor_loss(net, model, ia, ib, T)
    if kind == "descriptor":
        return ld
    return ld + jsp.detector_loss(net, model, imgs, labels)


def _torch_loss(kind, net, imgs, labels, ia, ib, T):
    im, lab = tsp.to_images(imgs, "cpu"), torch.from_numpy(labels).long()
    a, b, t = tsp.to_images(ia, "cpu"), tsp.to_images(ib, "cpu"), \
        torch.from_numpy(T)
    if kind == "detector":
        return tsp.detector_loss(net, im, lab)
    ld = tsp.descriptor_loss(net, a, b, t)
    if kind == "descriptor":
        return ld
    return ld + tsp.detector_loss(net, im, lab)


@pytest.mark.parametrize("kind,shift", [
    ("detector", None), ("descriptor", None), ("joint", None),
    ("descriptor", (4.0, 0.0)), ("descriptor", (-4.0, 4.0))],
    ids=["detector", "descriptor", "joint", "descriptor_tie_x",
         "descriptor_tie_xy"])
def test_loss_and_gradients_match(synthetic, kind, shift):
    flax, state = synthetic
    inputs = _inputs(shift=shift)
    jin = [jnp.asarray(x) for x in inputs]
    lj, gj = jax.value_and_grad(
        lambda p: _jax_loss(kind, p, *jin))(flax)
    net = _net(state)
    lt = _torch_loss(kind, net, *inputs)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    # a head the loss does not reach has no .grad; JAX's gradient is zero
    grads = superpoint_params_to_flax(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in net.named_parameters()})
    want = flatten_dict(gj, sep="/")
    assert sorted(grads) == sorted(want)
    for key, g in grads.items():
        ref = _np(want[key])
        scale = np.abs(ref).max()
        assert np.abs(g - ref).max() <= 1e-4 * scale, (key, scale)


def test_descriptor_ties_keep_the_first_index():
    """A shift of half a cell along x puts every warped centre exactly
    midway between cells c and c + 1: the target is c, the first index, as
    jnp.argmin gives; both directions equal the JAX oracle's."""
    *_, T = _inputs(shift=(4.0, 0.0))
    tgt, ok, tgt_b, ok_b = tsp.cell_correspondences(torch.from_numpy(T),
                                                    H, W)
    n = (H // 8) * (W // 8)
    assert torch.equal(tgt, torch.arange(n).expand(2, n))
    ys, xs = jnp.mgrid[:H // 8, :W // 8]
    ctr = jnp.stack([xs * 8.0 + 4.0, ys * 8.0 + 4.0], -1).reshape(-1, 2)
    warped = jnp.einsum("bij,nj->bni", T[:, :, :2], ctr) + T[:, None, :, 2]
    d2 = jnp.sum((warped[:, :, None, :] - ctr[None, None]) ** 2, -1)
    np.testing.assert_array_equal(tgt.numpy(), _np(jnp.argmin(d2, -1)))
    np.testing.assert_array_equal(
        tgt_b.numpy(), _np(jnp.argmin(jnp.swapaxes(d2, 1, 2), -1)))


def test_three_adam_steps_of_train_detector(synthetic):
    flax, state = synthetic
    kw = dict(steps=3, batch=2, h=H, w=W, seed=0, log_every=1)
    _, want = jsp.train_detector(params=flax, **kw)
    _, got = tsp.train_detector(params=state, device="cpu", **kw)
    assert [it for it, _ in got] == [0, 1, 2]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-4)


def test_init_superpoint_matches_flax_per_layer_std():
    flax = jsp_model.SuperPoint().init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, H, W, 1)))
    want = flatten_dict(flax, sep="/")
    got = superpoint_params_to_flax(
        tsp_model.init_superpoint(torch.Generator().manual_seed(0))
        .state_dict())
    assert sorted(got) == sorted(want)
    for key, v in got.items():
        ref = _np(want[key])
        if key.endswith("bias"):
            assert not v.any() and not ref.any(), key
        else:
            assert abs(v.std() / ref.std() - 1) < 0.05, key
            # truncated at 2 std of the untruncated normal
            fan_in = np.prod(v.shape[:3])
            bound = 2 * fan_in ** -0.5 / tsp_model.TRUNC_STD
            assert np.abs(v).max() <= bound * (1 + 1e-6), key


# ---------------------------------------------------------------------------
# Metrics on the bundled checkpoints
# ---------------------------------------------------------------------------

def test_detection_metrics_equal(synthetic):
    flax, state = synthetic
    want = jsp.detection_metrics(flax, n_eval=3)
    got = tsp.detection_metrics(state, n_eval=3, device="cpu")
    assert want["tp"] > 5
    assert got == want


@pytest.mark.parametrize("row", ["easy_jl", "textured_pca"])
def test_matching_metrics_equal(row):
    if row == "easy_jl":                # no PCA: JAX's JL matrix passed in
        path, kw = WEIGHTS / "superpoint_synthetic.npz", {}
        proj = _np(jax.random.normal(jax.random.PRNGKey(0), (64, 256))
                   / 16.0)
    else:
        path, proj = WEIGHTS / "superpoint_photo_v2.npz", None
        kw = dict(max_rot=0.5, scale=(0.85, 1.2))
    flax = jsp_model.load_flax_npz(path)
    if row == "easy_jl":
        flax = {"net": flax["net"]}
    want = jsp.matching_metrics(
        flax, n_eval=3, render_fn=jsp.render_textured if kw else None, **kw)
    got = tsp.matching_metrics(
        train_entry.read_superpoint(path) if kw else tsp_model.net_state(
            train_entry.read_superpoint(path)),
        n_eval=3, render_fn=tsp.render_textured if kw else None,
        projection=proj, device="cpu", **kw)
    assert want["matches"] >= 20
    assert got == want


def test_sample_raw_descriptors_match(synthetic):
    flax, state = synthetic
    want = jsp.sample_raw_descriptors({"net": flax}, n_images=4, h=H, w=W,
                                      batch=2)
    got = tsp.sample_raw_descriptors(state, n_images=4, h=H, w=W, batch=2,
                                     device="cpu")
    assert got.shape == want.shape and len(got) > 10
    np.testing.assert_allclose(got, want, atol=1e-4)
    from tools.fit_pca import fit_pca
    for a, b in zip(tsp.fit_pca(got, 8), fit_pca(got, 8)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints, both directions
# ---------------------------------------------------------------------------

def _f16(state):
    return {k: v.half().float() for k, v in state.items()}


def _forward_pair(flax_net, state):
    imgs, _ = tsp.make_batch_textured(np.random.default_rng(4), 2, H, W)
    hj, dj = jsp_model.SuperPoint().apply(flax_net, jnp.asarray(imgs))
    with torch.no_grad():
        ht, dt = _net(state)(tsp.to_images(imgs, "cpu"))
    return (_np(hj), _np(dj)), (ht.numpy(), dt.numpy())


def test_port_checkpoint_loads_in_reference(tmp_path):
    state = tsp_model.init_superpoint(torch.Generator().manual_seed(3)) \
        .state_dict()
    comps, mean, _ = tsp.fit_pca(np.random.default_rng(0).normal(
        size=(300, 256)), 64)
    params = {**state, "pca_components": torch.from_numpy(comps),
              "pca_mean": torch.from_numpy(mean)}
    path = tmp_path / "sp.npz"
    tsp_model.save_flax_npz(params, path)
    loaded = jsp_model.load_flax_npz(str(path))
    np.testing.assert_array_equal(_np(loaded["pca_components"]),
                                  comps.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(_np(loaded["pca_mean"]),
                                  mean.astype(np.float16).astype(np.float32))
    (hj, dj), (ht, dt) = _forward_pair(loaded["net"], _f16(state))
    np.testing.assert_allclose(ht, hj, atol=1e-5)
    np.testing.assert_allclose(dt, dj, atol=1e-5)
    ext = tsp_model.pretrained_extractor("cpu", path=path)
    assert ext.pca_components.shape == (64, 256)


def test_reference_checkpoint_loads_in_port(tmp_path):
    net = jsp_model.SuperPoint().init(jax.random.PRNGKey(1),
                                      jnp.zeros((1, H, W, 1)))
    full = {"net": net, "pca_components": jnp.ones((64, 256)) / 16,
            "pca_mean": jnp.full((256,), 0.5)}
    path = tmp_path / "ref.npz"
    jsp_model.save_flax_npz(full, str(path))
    got = train_entry.read_superpoint(path)
    np.testing.assert_array_equal(got["pca_mean"].numpy(), 0.5)
    want = jsp_model.load_flax_npz(str(path))
    (hj, dj), (ht, dt) = _forward_pair(want["net"], tsp_model.net_state(got))
    np.testing.assert_allclose(ht, hj, atol=1e-5)
    np.testing.assert_allclose(dt, dj, atol=1e-5)


def test_load_params_npz_torch_original(tmp_path, synthetic):
    """A torch-original OIHW checkpoint (tools/convert_superpoint.py's
    layout) reads the same in both packages."""
    flax, _ = synthetic
    flat = superpoint_params_to_flax(tsp_model.net_state(
        superpoint_params_from_flax(flatten_dict(flax, sep="/"))))
    orig = {}
    for key, v in flat.items():
        _, conv, leaf = key.split("/")
        orig[f"{conv}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
            v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
    orig["pca_components"] = np.eye(64, 256, dtype=np.float32)
    orig["pca_mean"] = np.zeros(256, np.float32)
    path = tmp_path / "orig.npz"
    np.savez(path, **orig)
    want = jsp_model.load_params_npz(str(path))
    got = tsp_model.load_params_npz(path)
    np.testing.assert_array_equal(got["pca_components"].numpy(),
                                  _np(want["pca_components"]))
    (hj, dj), (ht, dt) = _forward_pair(want["net"], tsp_model.net_state(got))
    np.testing.assert_allclose(ht, hj, atol=1e-5)
    np.testing.assert_allclose(dt, dj, atol=1e-5)


def test_return_logits():
    net = tsp_model.init_superpoint(torch.Generator().manual_seed(0))
    imgs = torch.rand(2, 1, H, W, generator=torch.Generator().manual_seed(1))
    heat, desc, logits = net(imgs, return_logits=True)
    assert logits.shape == (2, H // 8, W // 8, 65)
    semi = torch.softmax(logits, -1)[..., :64]
    want = semi.reshape(2, H // 8, W // 8, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(2, H, W)
    torch.testing.assert_close(heat, want)
    h2, d2 = net(imgs)
    assert torch.equal(h2, heat) and torch.equal(d2, desc)


def test_textured_eval_rows_match_reference():
    path = WEIGHTS / "superpoint_photo_v2.npz"
    got = train_entry.textured_eval({"photo": path}, n_eval=1, device="cpu")
    flax = jsp_model.load_flax_npz(str(path))
    kw = dict(n_eval=1, max_rot=0.5, max_shift=12.0, scale=(0.85, 1.2))
    tex = jsp.matching_metrics(flax, render_fn=jsp.render_textured, **kw)
    flat = jsp.matching_metrics(flax, **kw)
    assert got["photo"] == {
        "textured_match_precision": tex["match_precision"],
        "textured_matches": tex["matches"],
        "flat_match_precision": flat["match_precision"],
        "flat_matches": flat["matches"]}


def test_superpoint_main_photometric_resumes(tmp_path):
    """The tool's photometric stage at a tiny size: its checkpoint loads in
    the reference (with the fitted PCA), and a rerun with --continue-out
    finds the stage done and only evaluates."""
    out = str(tmp_path / "sp.npz")
    argv = ["--steps", "2", "--batch", "2", "--height", "32", "--width",
            "48", "--descriptor-steps", "2", "--desc-batch", "2",
            "--stage", "photometric", "--ha-every", "2", "--fit-pca", "4",
            "--save-every", "1", "--continue-out", "--device", "cpu",
            "--out", out]
    res = train_entry.superpoint_main(argv)
    assert [it for it, _ in res["history_detector"]] == [0, 1]
    assert len(res["history_descriptor"]) == 2 and "matching" in res
    ref = jsp_model.load_flax_npz(out)
    assert ref["pca_components"].shape == (64, 256)
    np.testing.assert_array_equal(
        _np(ref["net"]["params"]["conv1a"]["bias"]),
        res["params"]["conv1a.bias"].half().float().numpy())
    again = train_entry.superpoint_main(argv)
    assert again["history_detector"] == again["history_descriptor"] == []
