"""Port vs reference: SuperPoint and MobileNetVLAD with the bundled weights.

Same images (numpy, seeded) through the Flax modules and the port's
``nn.Module``s on the CPU, both in f32. Tolerances: heat and descriptor
maps 1e-5 absolute; global descriptors 1e-4 absolute; keypoint validity
exact, keypoint xy within 1e-3 px and PCA descriptors within 1e-4 (the heat
maps differ by ~1e-7, which moves the subpixel centroids by ~1e-5 px).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from omniswarm_torch.convert import (netvlad_params_from_flax,
                                     superpoint_params_from_flax)
from omniswarm_torch.models import netvlad as tnv
from omniswarm_torch.models import superpoint as tsp
from omniswarm_tpu.models import netvlad as jnv
from omniswarm_tpu.models import superpoint as jsp

torch.set_num_threads(1)
H, W = 96, 160


def _images(seed, B=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    # smooth shapes plus noise, so SuperPoint finds corners
    img = rng.uniform(0.0, 0.3, size=(B, h, w))
    for b in range(B):
        for _ in range(12):
            y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
            img[b, y:y + rng.integers(4, 12), x:x + rng.integers(4, 12)] = \
                rng.uniform(0.5, 1.0)
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(
        np.float32)


@pytest.fixture(scope="module")
def superpoints():
    return (jsp.pretrained_extractor(height=H, width=W),
            tsp.pretrained_extractor("cpu"))


def test_superpoint_maps_match(superpoints):
    jext, text = superpoints
    imgs = _images(0)
    heat_j, desc_j = jext.model.apply(jext.params["net"],
                                      jnp.asarray(imgs[..., None]))
    with torch.no_grad():
        heat_t, desc_t = text.net(torch.from_numpy(imgs)[:, None])
    assert heat_t.shape == (2, H, W) and desc_t.shape == (2, H // 8, W // 8,
                                                          256)
    np.testing.assert_allclose(heat_t.numpy(), np.asarray(heat_j), atol=1e-5)
    np.testing.assert_allclose(desc_t.numpy(), np.asarray(desc_j), atol=1e-5)


def test_superpoint_extractor_matches(superpoints):
    jext, text = superpoints
    imgs = _images(1)
    xy_j, s_j, d_j, v_j = (np.asarray(v) for v in
                           jext(jnp.asarray(imgs[..., None])))
    xy_t, s_t, d_t, v_t = (v.numpy() for v in
                           text(torch.from_numpy(imgs)[:, None]))
    assert v_j.sum() > 50
    np.testing.assert_array_equal(v_t, v_j)
    sel = v_j
    np.testing.assert_allclose(xy_t[sel], xy_j[sel], atol=1e-3)
    np.testing.assert_allclose(s_t[sel], s_j[sel], atol=1e-5)
    np.testing.assert_allclose(d_t[sel], d_j[sel], atol=1e-4)


@pytest.mark.parametrize("weights,h,w", [
    ("netvlad_v2_revisit.npz", H, W), ("netvlad_v2_revisit.npz", 208, 400),
    ("netvlad_synthetic.npz", H, W)])
def test_netvlad_bundled_matches(weights, h, w):
    """v2 (GroupNorm) at the test size and at the path's 400 x 208, whose
    last stride-2 conv sees 13 rows (XLA pads (1, 1) there, (0, 1) on even
    sizes); v1 (plain separable convs with bias)."""
    path = str(tsp.WEIGHTS_DIR / weights)
    jext = jnv.GlobalDescriptorExtractor(
        jnv.load_netvlad_npz(path), num_clusters=8, out_dim=4096,
        use_proj=False, encoder_version=jnv.netvlad_meta(path)[
            "encoder_version"])
    text = tnv.pretrained_global_extractor("cpu", path=path)
    imgs = _images(2, B=2, h=h, w=w)
    want = np.asarray(jext(jnp.asarray(imgs[..., None])))
    got = text(torch.from_numpy(imgs)[:, None]).numpy()
    assert got.shape == (2, 4096)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_netvlad_projection_from_random_flax_init():
    """The projection head (unused by the bundled checkpoint) and the
    converter's Dense transpose, on a random Flax init."""
    model = jnv.MobileNetVLAD(num_clusters=4, out_dim=64, use_proj=True,
                              encoder_version=1)
    imgs = _images(3, B=2, h=48, w=64)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(imgs[..., None]))
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(params, sep="/").items()}
    text = tnv.GlobalDescriptorExtractor(
        netvlad_params_from_flax(flat), num_clusters=4, out_dim=64,
        use_proj=True, encoder_version=1)
    want = np.asarray(model.apply(params, jnp.asarray(imgs[..., None])))
    got = text(torch.from_numpy(imgs)[:, None]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_superpoint_converter_layouts():
    flat = tsp.load_flax_npz(tsp.DEFAULT_WEIGHTS)
    sd = superpoint_params_from_flax(flat)
    k = flat["params/conv2a/kernel"]                     # HWIO
    np.testing.assert_array_equal(sd["net.conv2a.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    assert sd["net.convPb.weight"].shape == (65, 256, 1, 1)
    assert sd["pca_components"].shape == (64, 256)
    assert all(v.dtype == torch.float32 for v in sd.values())
    raw = np.load(tsp.DEFAULT_WEIGHTS)
    np.testing.assert_array_equal(
        sd["net.conv1a.bias"].numpy(),
        np.asarray(jnp.asarray(raw["params/conv1a/bias"], jnp.float32)))
    nsd = netvlad_params_from_flax(tnv.load_netvlad_npz(tnv.DEFAULT_WEIGHTS))
    assert nsd["model.encoder.sep2.dw.weight"].shape == (128, 1, 3, 3)
    assert nsd["model.vlad.assign.weight"].shape == (8, 512)
    assert "model.encoder.sep6.pw_gn.weight" in nsd
