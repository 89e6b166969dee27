"""Port's bf16 CNN trunks: against the port's f32 and against JAX's bf16.

The bars are ``tests/test_bf16_frontend.py``'s, at its 96 x 160 images of
``render_shapes`` (numpy, seeded): heat maps within 0.03, coarse
descriptor cosine above 0.995, more than 90% of the keypoints matched
within 1 px, global-descriptor cosine above 0.99 and pairwise similarities
within 0.02. The CPU's bf16 convolutions, cuDNN's and XLA's round their
accumulations differently, so bf16 is held to these bars, never bit for
bit. Both NetVLAD encoders: the bundled v2 checkpoint and v1's
``netvlad_synthetic.npz``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.models import netvlad as tnv
from omniswarm_torch.models import superpoint as tsp
from omniswarm_tpu.models import netvlad as jnv
from omniswarm_tpu.models import superpoint as jsp
from omniswarm_tpu.models.train_superpoint import render_shapes

torch.set_num_threads(1)
H, W = 96, 160
ENCODERS = ("netvlad_v2_revisit.npz", "netvlad_synthetic.npz")


def _images(n=2, seed=0):
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, H, W), np.float32)
    for i in range(n):
        imgs[i], _ = render_shapes(rng, H, W, n_shapes=8)
    return imgs


def _keypoints_agree(a_out, b_out):
    """More than 90% of a's valid keypoints have one of b's within 1 px,
    image by image; neither may drop every keypoint the other found."""
    (xy_a, _, _, v_a), (xy_b, _, _, v_b) = a_out, b_out
    for b in range(xy_a.shape[0]):
        a, c = xy_a[b][v_a[b]], xy_b[b][v_b[b]]
        if len(a) == 0 or len(c) == 0:
            assert len(a) == len(c) == 0, (b, len(a), len(c))
            continue
        d = np.linalg.norm(a[:, None] - c[None], axis=-1)
        assert (d.min(axis=1) < 1.0).mean() > 0.9, b


def _maps_agree(heat_a, desc_a, heat_b, desc_b):
    assert np.max(np.abs(heat_a - heat_b)) < 0.03
    assert np.min(np.sum(desc_a * desc_b, axis=-1)) > 0.995


def _globals_agree(d_a, d_b):
    assert np.sum(d_a * d_b, axis=-1).min() > 0.99
    assert np.max(np.abs(d_a @ d_a.T - d_b @ d_b.T)) < 0.02


@pytest.fixture(scope="module")
def superpoint_outputs():
    """(maps, extractor outputs) of the port in f32 and bf16 and of JAX in
    bf16, on the same images, as numpy."""
    imgs = _images()
    x = torch.from_numpy(imgs)[:, None]
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ext = tsp.pretrained_extractor("cpu", max_keypoints=64, dtype=dtype)
        with torch.no_grad():
            heat, desc = ext.net(x)
            assert heat.dtype == desc.dtype == torch.float32
            out[name] = ((heat.numpy(), desc.numpy()),
                         tuple(v.numpy() for v in ext(x)))
    jext = jsp.pretrained_extractor(height=H, width=W, max_keypoints=64,
                                    dtype=jnp.bfloat16)
    xj = jnp.asarray(imgs[..., None])
    heat, desc = jext.model.apply(jext.params["net"], xj)
    assert heat.dtype == jnp.float32
    out["jax_bf16"] = ((np.asarray(heat), np.asarray(desc)),
                       tuple(np.asarray(v) for v in jext(xj)))
    return out


@pytest.mark.parametrize("ref", ["f32", "jax_bf16"])
def test_superpoint_bf16_maps(superpoint_outputs, ref):
    _maps_agree(*superpoint_outputs["bf16"][0], *superpoint_outputs[ref][0])


@pytest.mark.parametrize("ref", ["f32", "jax_bf16"])
def test_superpoint_bf16_keypoints(superpoint_outputs, ref):
    _keypoints_agree(superpoint_outputs[ref][1],
                     superpoint_outputs["bf16"][1])


def test_bf16_casts_in_the_module():
    """The converters and the modules keep f32 weights: a bf16 extractor's
    state is the f32 extractor's, bit for bit, and stays f32 after a
    forward (the cast to bf16 happens inside each call)."""
    f32 = tsp.pretrained_extractor("cpu", max_keypoints=8)
    bf16 = tsp.pretrained_extractor("cpu", max_keypoints=8,
                                    dtype=torch.bfloat16)
    bf16(torch.from_numpy(_images(1))[:, None])
    nv = tnv.pretrained_global_extractor("cpu", dtype=torch.bfloat16)
    nv(torch.from_numpy(_images(1))[:, None])
    for a, b in ((f32.state_dict(), bf16.state_dict()),
                 (tnv.pretrained_global_extractor("cpu").state_dict(),
                  nv.state_dict())):
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("weights", ENCODERS)
@pytest.mark.parametrize("ref", ["f32", "jax_bf16"])
def test_netvlad_bf16_trunk_preserves_retrieval(weights, ref):
    imgs = _images(n=6, seed=1)
    path = tsp.WEIGHTS_DIR / weights
    x = torch.from_numpy(imgs)[:, None]
    d16 = tnv.pretrained_global_extractor("cpu", path=path,
                                          dtype=torch.bfloat16)(x)
    assert d16.dtype == torch.float32
    if ref == "f32":
        want = tnv.pretrained_global_extractor("cpu", path=path)(x).numpy()
    else:
        jext = jnv.GlobalDescriptorExtractor(
            jnv.load_netvlad_npz(str(path)), num_clusters=8, out_dim=4096,
            use_proj=False, dtype=jnp.bfloat16,
            encoder_version=jnv.netvlad_meta(str(path))["encoder_version"])
        want = np.asarray(jext(jnp.asarray(imgs[..., None])))
    _globals_agree(d16.numpy(), want)
