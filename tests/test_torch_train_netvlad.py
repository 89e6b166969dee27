"""Port vs reference: the MobileNetVLAD training path.

The same seeds, weights and views go through
``omniswarm_tpu/models/train_netvlad.py`` and
``omniswarm_torch/models/train_netvlad.py`` on the CPU; the JAX side runs
under ``jax.default_matmul_precision("highest")``. Tolerances: host renders
bit-identical; ``ntxent_loss`` rtol 1e-5 and its gradient within 1e-4 of
its max-abs value; ``device_render_views`` with JAX's draws injected within
1e-5; the cosine ``LambdaLR`` within 1e-7 of optax's schedule at every
step; one Adam update of MobileNetVLAD v2 at 48 x 80 (loss rtol 1e-5,
gradients within 2e-4 of their max-abs values, the updated parameters
within 1e-4 of optax's update on the same gradients);
``retrieval_metrics`` of the bundled checkpoint at 12 places equal; a
checkpoint written by either package read by the other gives the same
descriptors within 1e-5 (the f16 file's weights in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from omniswarm_torch import train_entry
from omniswarm_torch.convert import netvlad_params_to_flax
from omniswarm_torch.models import netvlad as tnv_model
from omniswarm_torch.models import train_netvlad as tnv
from omniswarm_tpu.models import netvlad as jnv_model
from omniswarm_tpu.models import train_netvlad as jnv

torch.set_num_threads(1)
V2 = tnv_model.WEIGHTS_DIR / "netvlad_v2_revisit.npz"
CANVAS, VIEW = (112, 176), (48, 80)


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _jax_model(version=2):
    return jnv_model.MobileNetVLAD(
        num_clusters=jnv_model.BUNDLED_CLUSTERS,
        out_dim=jnv_model.BUNDLED_OUT_DIM, use_proj=False,
        encoder_version=version)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

RENDERS = {
    "render_place": lambda m, r: m.render_place(r, *CANVAS),
    "render_place_textured": lambda m, r: m.render_place(r, 64, 96,
                                                         textured=True),
    "render_view": lambda m, r: m.render_view(
        r, m.render_place(r, *CANVAS), *VIEW, max_rot=0.5,
        scale=(0.8, 1.25), return_center=True),
    "render_view_pinned": lambda m, r: m.render_view(
        r, m.render_place(r, *CANVAS), *VIEW, noise=0.06,
        center=(5.0, 170.0)),
    "place_pool_batch": lambda m, r: m.PlacePool(
        4, canvas=CANVAS, view=VIEW, seed=int(r.integers(100))).batch(3),
}


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _flat(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_renders_bit_identical(name):
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    want, got = _flat(RENDERS[name](jnv, rj)), _flat(RENDERS[name](tnv, rt))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    assert rj.uniform() == rt.uniform()


# ---------------------------------------------------------------------------
# Loss, device rendering, schedule
# ---------------------------------------------------------------------------

def test_ntxent_loss_and_gradient_match():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(12, 32)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lj, gj = jax.value_and_grad(jnv.ntxent_loss)(jnp.asarray(d))
    dt = torch.from_numpy(d).requires_grad_()
    lt = tnv.ntxent_loss(dt)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    gj = _np(gj)
    assert np.abs(dt.grad.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


def _jax_draws(key, n, vh, vw, max_rot, scale):
    """JAX's draws for ``device_render_views(key)``, in its key order."""
    ka, kc, kg, kb, kn, kz = jax.random.split(key, 6)
    t = lambda x: torch.from_numpy(np.array(x))
    return tnv.ViewDraws(
        ang=t(jax.random.uniform(ka, (n,), minval=-max_rot, maxval=max_rot)),
        zoom=t(jax.random.uniform(kz, (n,), minval=scale[0],
                                  maxval=scale[1])),
        ctr=t(jax.random.uniform(kc, (n, 2))),
        gain=t(jax.random.uniform(kg, (n, 1, 1), minval=0.7, maxval=1.3)),
        bias=t(jax.random.uniform(kb, (n, 1, 1), minval=-0.1, maxval=0.1)),
        noise=t(jax.random.normal(kn, (n, vh, vw))))


@pytest.mark.parametrize("pinned,max_rot,scale", [
    (False, 0.25, (1.0, 1.0)), (False, 0.5, (0.8, 1.25)),
    (True, 0.5, (0.8, 1.25))], ids=["default", "hard", "pinned"])
def test_device_render_views_with_jax_draws(pinned, max_rot, scale):
    pool = jnv.PlacePool(n_places=3, canvas=CANVAS, view=VIEW, seed=1)
    places = np.stack(pool.places)
    idx = np.asarray([2, 0, 2, 1])
    centers = (np.asarray([[0.0, 0.0], [56.0, 88.0], [200.0, 90.0],
                           [40.0, 300.0]], np.float32) if pinned else None)
    key = jax.random.PRNGKey(3)
    want = jnv.device_render_views(
        jnp.asarray(places), jnp.asarray(idx), key, *VIEW, max_rot=max_rot,
        noise=0.06, scale=scale,
        centers=None if centers is None else jnp.asarray(centers))
    got = tnv.device_render_views(
        torch.from_numpy(places), torch.from_numpy(idx),
        _jax_draws(key, 4, *VIEW, max_rot, scale), *VIEW, noise=0.06,
        centers=None if centers is None else torch.from_numpy(centers))
    assert got.shape == (4, 1) + VIEW
    np.testing.assert_allclose(got[:, 0].numpy(), _np(want)[..., 0],
                               atol=1e-5)


def test_view_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = tnv.view_draws(5, *VIEW, g, max_rot=0.5, scale=(0.8, 1.25))
    assert d.noise.shape == (5,) + VIEW and d.gain.shape == (5, 1, 1)
    assert d.ang.abs().max() <= 0.5 and d.zoom.min() >= 0.8
    assert d.zoom.max() <= 1.25 and ((d.ctr >= 0) & (d.ctr < 1)).all()
    again = tnv.view_draws(5, *VIEW, torch.Generator().manual_seed(0),
                           max_rot=0.5, scale=(0.8, 1.25))
    assert all(torch.equal(a, b) for a, b in zip(d, again))


@pytest.mark.parametrize("steps", [200, 1000])
def test_cosine_schedule_matches_optax(steps):
    lr = 3e-4
    want = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=max(steps // 20, 10), decay_steps=steps,
        end_value=lr * 0.01)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, tnv.warmup_cosine(steps))
    got = []
    for _ in range(steps):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, [float(want(i)) for i in range(steps)],
                               rtol=0, atol=1e-7)
    assert got[0] == 0.0


def test_first_cosine_update_takes_lr_zero():
    kw = dict(steps=1, places_per_batch=2, pool_size=3, view=VIEW,
              device="cpu", encoder_version=2)
    p0, _ = tnv.train_netvlad(cosine=False, **kw)
    p1, _ = tnv.train_netvlad(cosine=True, **kw)
    init = tnv_model.init_mobilenetvlad(torch.Generator().manual_seed(0), 2)
    for k, v in init.state_dict().items():
        assert torch.equal(p1[k], v), k
    assert any(not torch.equal(p0[k], v)
               for k, v in init.state_dict().items())


# ---------------------------------------------------------------------------
# One update step, metrics, init
# ---------------------------------------------------------------------------

def test_one_update_step_matches():
    """One Adam update from the bundled v2 weights on the same 2 x 2 views.

    The loss and the gradients are held to JAX's. The update is held with
    both packages' Adam on the port's gradients: on JAX's own gradients a
    weight whose gradient is near eps = 1e-8 moves by lr * g / (|g| + eps),
    so the two packages' f32 rounding of such a g (1e-9 apart) moves it by
    up to lr (6.8e-5 on a weight of ``sep5/pw``, whose bar here would be
    3.1e-5)."""
    flax = jnv_model.load_netvlad_npz(str(V2))
    state = train_entry.read_netvlad(V2)
    pool = jnv.PlacePool(n_places=2, canvas=CANVAS, view=VIEW, seed=4)
    views = pool.batch(2)                               # (4, 48, 80, 1)
    model = _jax_model()

    def loss_fn(p):
        return jnv.ntxent_loss(model.apply(p, jnp.asarray(views)))

    lj, gj = jax.jit(jax.value_and_grad(loss_fn))(flax)
    net = tnv.load_netvlad(state, 2, 0, "cpu")
    opt = tnv.adam(net, 3e-4)
    opt.zero_grad()
    lt = tnv.ntxent_loss(net(torch.from_numpy(views[..., 0])[:, None]))
    lt.backward()
    grads = netvlad_params_to_flax({n: p.grad for n, p in
                                    net.named_parameters()})
    opt.step()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    gj = flatten_dict(gj, sep="/")
    assert sorted(grads) == sorted(gj)
    for key in grads:
        # 2e-4: the stem GroupNorm scale's gradient sums 4 x 960 terms, and
        # JAX's f32 sum lies 8.5e-5 of its max-abs value from a float64
        # evaluation (the port's 2.1e-5), 1.06e-4 from the port's
        ref = _np(gj[key])
        assert np.abs(grads[key] - ref).max() <= 2e-4 * np.abs(ref).max(), key
    tx = optax.adam(3e-4)
    gflat = {tuple(k.split("/")): jnp.asarray(v) for k, v in grads.items()}
    updates, _ = tx.update(unflatten_dict(gflat), tx.init(flax))
    want = flatten_dict(optax.apply_updates(flax, updates), sep="/")
    got = netvlad_params_to_flax(net.state_dict())
    for key, v in got.items():
        p_j = _np(want[key])
        assert np.abs(v - p_j).max() <= 1e-4 * np.abs(p_j).max(), key


def test_retrieval_metrics_equal():
    flax = jnv_model.load_netvlad_npz(str(V2))
    kw = dict(n_places=12, max_rot=0.5, noise=0.06, scale=(0.8, 1.25),
              revisit_offset=0.35, encoder_version=2, view=VIEW)
    want = jnv.retrieval_metrics(flax, **kw)
    got = tnv.retrieval_metrics(train_entry.read_netvlad(V2), device="cpu",
                                **kw)
    assert got["recall_at_1"] == want["recall_at_1"]
    assert want["recall_at_1"] >= 0.5
    for k in ("mean_margin", "mean_pos_sim", "mean_top_neg_sim"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5)


@pytest.mark.parametrize("version", [1, 2])
def test_init_mobilenetvlad_matches_flax(version):
    flax = _jax_model(version).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1,) + VIEW + (1,)))
    want = flatten_dict(flax, sep="/")
    got = netvlad_params_to_flax(tnv_model.init_mobilenetvlad(
        torch.Generator().manual_seed(0), version).state_dict())
    assert sorted(got) == sorted(want)
    for key, v in got.items():
        ref = _np(want[key])
        if key.endswith("bias"):
            assert not v.any() and not ref.any(), key
        elif key.endswith("scale"):
            assert (v == 1).all() and (ref == 1).all(), key
        else:
            # per-layer std within 5%, or within 3 standard errors of the
            # difference of two sample stds (sqrt(1 / N) relative) for the
            # 288-weight stem and first depthwise kernel; a depthwise
            # kernel's fan_in is 9
            tol = max(0.05, 3 / np.sqrt(v.size))
            assert abs(v.std() / ref.std() - 1) < tol, (key, v.std(),
                                                        ref.std())


# ---------------------------------------------------------------------------
# Checkpoints, both directions
# ---------------------------------------------------------------------------

def _descs(flax, state, version):
    imgs = jnv.PlacePool(n_places=2, canvas=CANVAS, view=VIEW,
                         seed=6).batch(2)
    want = _jax_model(version).apply(flax, jnp.asarray(imgs))
    with torch.no_grad():
        got = tnv.load_netvlad(state, version, 0, "cpu")(
            torch.from_numpy(imgs[..., 0])[:, None])
    return _np(want), got.numpy()


@pytest.mark.parametrize("version", [1, 2])
def test_port_checkpoint_loads_in_reference(tmp_path, version):
    model = tnv_model.init_mobilenetvlad(torch.Generator().manual_seed(2),
                                         version)
    path = tmp_path / "nv.npz"
    tnv_model.save_netvlad_npz(model.state_dict(), path,
                               encoder_version=version)
    assert jnv_model.netvlad_meta(str(path)) == {"encoder_version": version}
    flax = jnv_model.load_netvlad_npz(str(path))
    f16 = {k: v.half().float() for k, v in model.state_dict().items()}
    want, got = _descs(flax, f16, version)
    np.testing.assert_allclose(got, want, atol=1e-5)
    ext = tnv_model.pretrained_global_extractor("cpu", path=path)
    assert isinstance(ext.model.encoder, tnv_model.MobileNetEncoderV2) == (
        version == 2)


def test_reference_checkpoint_loads_in_port(tmp_path):
    flax = _jax_model(2).init(jax.random.PRNGKey(5),
                              jnp.zeros((1,) + VIEW + (1,)))
    path = tmp_path / "ref.npz"
    jnv_model.save_netvlad_npz(flax, str(path), encoder_version=2)
    assert tnv_model.netvlad_meta(path) == {"encoder_version": 2}
    want, got = _descs(jnv_model.load_netvlad_npz(str(path)),
                       train_entry.read_netvlad(path), 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resume_sidecar_round_trip(tmp_path):
    """The sidecar holds the f32 parameters and Adam's state by name; a
    fresh model and optimiser loaded from it equal the trained ones."""
    resume = str(tmp_path / "nv.resume.npz")
    params, _ = tnv.train_netvlad(
        steps=2, places_per_batch=2, pool_size=3, view=VIEW, device="cpu",
        encoder_version=2, save_every=1, cosine=True,
        save_path=str(tmp_path / "nv.npz"), resume_path=resume)
    assert tnv_model.netvlad_meta(tmp_path / "nv.npz") == {
        "encoder_version": 2}
    model = tnv.load_netvlad(None, 2, 1, "cpu")
    opt = tnv.adam(model, 3e-4)
    assert tnv.load_resume(resume, model, opt) == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    assert len(opt.state) == len(list(model.parameters()))


def test_netvlad_main_writes_a_reference_checkpoint(tmp_path):
    out = tmp_path / "nv.npz"
    res = train_entry.netvlad_main([
        "--steps", "2", "--places", "2", "--pool", "3", "--arch", "2",
        "--cosine", "--save-every", "1", "--device", "cpu",
        "--out", str(out)])
    assert [it for it, _ in res["history"]] == [0, 1]
    assert 0.0 <= res["easy"]["recall_at_1"] <= 1.0
    assert jnv_model.netvlad_meta(str(out)) == {"encoder_version": 2}
    flax = flatten_dict(jnv_model.load_netvlad_npz(str(out)), sep="/")
    np.testing.assert_array_equal(
        _np(flax["params/vlad/centroids"]),
        res["params"]["vlad.centroids"].half().float().numpy())
