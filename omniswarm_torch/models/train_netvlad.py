"""MobileNetVLAD place-recognition training on synthetic places, on the card.

Counterpart of ``omniswarm_tpu/models/train_netvlad.py``: each place is a
canvas of random structure rendered once on the host (``PlacePool``); every
step renders two views of 16 places on the device (``device_render_views``:
rotated, shifted bilinear crops with gain, bias and noise) and takes one
Adam step on the in-batch NT-Xent loss, which pulls the two views of a place
together on the descriptor sphere and pushes other places away.
``retrieval_metrics`` scores recall@1 of held-out queries against a gallery
by the reference's dense ``argmax(dq @ dg.T)``.

Where the reference draws from ``jax.random``, the port draws from a
``torch.Generator`` on the training device; ``device_render_views`` also
takes its draws as an argument (``ViewDraws``) so a test can inject JAX's.
The host renderers are numpy copies: the same ``np.random.Generator`` state
gives bit-identical canvases and views.

The periodic checkpoint is the reference's f16 ``save_netvlad_npz`` layout.
The resume sidecar (f32 parameters and Adam's moments and step, keyed by
parameter name) is the port's own: it does not read or write optax's
leaf-ordered sidecar.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.models.netvlad import (BUNDLED_CLUSTERS,
                                            BUNDLED_OUT_DIM, MobileNetVLAD,
                                            init_mobilenetvlad, model_state,
                                            save_netvlad_npz)
from omniswarm_torch.models.train_superpoint import (adam, as_state,
                                                     render_textured,
                                                     state_of, to_images)
from omniswarm_torch.sim.image_world import render_shapes


# ---------------------------------------------------------------------------
# Synthetic places (host-side numpy)
# ---------------------------------------------------------------------------

def render_place(rng: np.random.Generator, h: int, w: int,
                 textured: bool = False) -> np.ndarray:
    """A place: a dense canvas of line-art shapes, or of textured polygons
    over multi-scale noise with ``textured``."""
    if textured:
        img, _ = render_textured(rng, h, w,
                                 n_shapes=int(rng.integers(8, 14)))
        return img
    img, _ = render_shapes(rng, h, w, n_shapes=int(rng.integers(10, 18)))
    return img


def _margins(ph: int, pw: int, vh: int, vw: int) -> Tuple[float, float]:
    """The crop-centre margins that keep a rotated view inside the canvas."""
    half = 0.5 * float(np.hypot(vh, vw)) + 2
    return min(half, (ph - 2) / 2.0), min(half, (pw - 2) / 2.0)


def render_view(rng: np.random.Generator, place: np.ndarray, vh: int,
                vw: int, *, max_rot: float = 0.25,
                noise: float = 0.03,
                scale: Tuple[float, float] = (1.0, 1.0),
                center=None, return_center: bool = False):
    """A view of a place: a rotated, zoomed, shifted bilinear crop with
    gain, bias and noise. ``center`` pins the crop centre (clipped to the
    margins); ``return_center`` also returns the (cy, cx) used."""
    ph, pw = place.shape
    ang = rng.uniform(-max_rot, max_rot)
    zoom = rng.uniform(*scale)
    c, s = np.cos(ang) * zoom, np.sin(ang) * zoom
    margin_y, margin_x = _margins(ph, pw, vh, vw)
    if center is None:
        cy = rng.uniform(margin_y, ph - margin_y)
        cx = rng.uniform(margin_x, pw - margin_x)
    else:
        cy = float(np.clip(center[0], margin_y, ph - margin_y))
        cx = float(np.clip(center[1], margin_x, pw - margin_x))
    ys, xs = np.mgrid[:vh, :vw].astype(np.float32)
    ys -= vh / 2.0
    xs -= vw / 2.0
    sy = cy + c * ys - s * xs
    sx = cx + s * ys + c * xs
    y0 = np.clip(np.floor(sy).astype(int), 0, ph - 2)
    x0 = np.clip(np.floor(sx).astype(int), 0, pw - 2)
    fy = np.clip(sy - y0, 0, 1)
    fx = np.clip(sx - x0, 0, 1)
    v = (place[y0, x0] * (1 - fy) * (1 - fx)
         + place[y0 + 1, x0] * fy * (1 - fx)
         + place[y0, x0 + 1] * (1 - fy) * fx
         + place[y0 + 1, x0 + 1] * fy * fx)
    gain = rng.uniform(0.7, 1.3)
    bias = rng.uniform(-0.1, 0.1)
    v = np.clip(v * gain + bias
                + rng.normal(0, noise, v.shape).astype(np.float32), 0, 1)
    v = v.astype(np.float32)
    if return_center:
        return v, (cy, cx)
    return v


class PlacePool:
    """Pre-rendered canvas pool sampled for (place, 2 views) batches."""

    def __init__(self, n_places: int = 256,
                 canvas: Tuple[int, int] = (224, 352),
                 view: Tuple[int, int] = (96, 160), seed: int = 0,
                 textured: bool = False):
        self.rng = np.random.default_rng(seed)
        self.view = view
        self.places = [render_place(self.rng, *canvas, textured=textured)
                       for _ in range(n_places)]

    def batch(self, n: int) -> np.ndarray:
        """(2n, vh, vw, 1): rows [0:n] and [n:2n] are paired views."""
        idx = self.rng.choice(len(self.places), size=n, replace=False)
        vh, vw = self.view
        out = np.zeros((2 * n, vh, vw, 1), np.float32)
        for i, pi in enumerate(idx):
            out[i, :, :, 0] = render_view(self.rng, self.places[pi], vh, vw)
            out[n + i, :, :, 0] = render_view(self.rng, self.places[pi],
                                              vh, vw)
        return out


# ---------------------------------------------------------------------------
# Loss and device rendering
# ---------------------------------------------------------------------------

def ntxent_loss(desc: torch.Tensor, temperature: float = 0.1
                ) -> torch.Tensor:
    """In-batch NT-Xent over (2n, D) unit descriptors, pairs (i, n + i)."""
    n = desc.shape[0] // 2
    sim = desc @ desc.T / temperature                      # (2n, 2n)
    sim = sim - 1e9 * torch.eye(2 * n, device=desc.device)  # mask self
    ar = torch.arange(n, device=desc.device)
    targets = torch.cat([ar + n, ar])
    logp = torch.log_softmax(sim, dim=-1)
    return -torch.mean(torch.gather(logp, 1, targets[:, None]))


class ViewDraws(NamedTuple):
    """The random draws of one ``device_render_views`` call, for n views:
    ang (n,) in [-max_rot, max_rot), zoom (n,) in [scale), ctr (n, 2) in
    [0, 1) (the crop centre inside the margins; unused when centres are
    pinned), gain (n, 1, 1) in [0.7, 1.3), bias (n, 1, 1) in [-0.1, 0.1),
    noise (n, vh, vw) standard normal."""
    ang: torch.Tensor
    zoom: torch.Tensor
    ctr: torch.Tensor
    gain: torch.Tensor
    bias: torch.Tensor
    noise: torch.Tensor


def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def view_draws(n: int, vh: int, vw: int, generator: torch.Generator, *,
               max_rot: float = 0.25,
               scale: Tuple[float, float] = (1.0, 1.0)) -> ViewDraws:
    """``ViewDraws`` for n views from ``generator``, on its device."""
    dev = generator.device
    return ViewDraws(
        ang=_uniform((n,), -max_rot, max_rot, generator, dev),
        zoom=_uniform((n,), scale[0], scale[1], generator, dev),
        ctr=torch.rand((n, 2), generator=generator, device=dev),
        gain=_uniform((n, 1, 1), 0.7, 1.3, generator, dev),
        bias=_uniform((n, 1, 1), -0.1, 0.1, generator, dev),
        noise=torch.randn((n, vh, vw), generator=generator, device=dev))


def device_render_views(places: torch.Tensor, idx: torch.Tensor,
                        draws: ViewDraws, vh: int, vw: int, *,
                        noise: float = 0.03,
                        centers: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``render_view`` on the device: places (N, ph, pw), idx (n,) ->
    (n, 1, vh, vw) views with ``draws``. ``centers`` (n, 2) pins the crop
    centres in canvas pixels (clipped to the margins). A plain bilinear
    gather: the reference computes it in XLA, not in a kernel of its own."""
    ph, pw = places.shape[1:]
    n = idx.shape[0]
    pl = places[idx]
    c = torch.cos(draws.ang) * draws.zoom
    s = torch.sin(draws.ang) * draws.zoom
    my, mx = _margins(ph, pw, vh, vw)
    if centers is None:
        cy = my + draws.ctr[:, 0] * (ph - 2 * my)
        cx = mx + draws.ctr[:, 1] * (pw - 2 * mx)
    else:
        cy = torch.clamp(centers[:, 0], my, ph - my)
        cx = torch.clamp(centers[:, 1], mx, pw - mx)
    dev = places.device
    ys = torch.arange(vh, device=dev, dtype=torch.float32)[:, None] - vh / 2.0
    xs = torch.arange(vw, device=dev, dtype=torch.float32)[None, :] - vw / 2.0
    c, s = c[:, None, None], s[:, None, None]
    sy = cy[:, None, None] + c * ys - s * xs
    sx = cx[:, None, None] + s * ys + c * xs
    y0 = torch.clamp(torch.floor(sy).long(), 0, ph - 2)
    x0 = torch.clamp(torch.floor(sx).long(), 0, pw - 2)
    fy = torch.clamp(sy - y0, 0, 1)
    fx = torch.clamp(sx - x0, 0, 1)
    b = torch.arange(n, device=dev)[:, None, None]
    v = (pl[b, y0, x0] * (1 - fy) * (1 - fx)
         + pl[b, y0 + 1, x0] * fy * (1 - fx)
         + pl[b, y0, x0 + 1] * (1 - fy) * fx
         + pl[b, y0 + 1, x0 + 1] * fy * fx)
    v = torch.clamp(v * draws.gain + draws.bias + noise * draws.noise, 0, 1)
    return v[:, None]


def revisit_centers(places: torch.Tensor, n: int, vh: int, vw: int,
                    offset: float, generator: torch.Generator):
    """Crop centres (ca, cb) of n revisit pairs: anchors uniform inside the
    rotation-safe margins, partners within ``offset`` * (vh, vw) of them."""
    ph, pw = places.shape[1:]
    dev = generator.device
    my, mx = _margins(ph, pw, vh, vw)
    u = torch.rand((n, 2), generator=generator, device=dev)
    ca = (torch.tensor([my, mx], device=dev)
          + u * torch.tensor([ph - 2 * my, pw - 2 * mx], device=dev))
    delta = _uniform((n, 2), -1.0, 1.0, generator, dev)
    cb = ca + delta * torch.tensor([offset * vh, offset * vw], device=dev)
    return ca, cb


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def warmup_cosine(steps: int):
    """The multiplier of ``LambdaLR`` that reproduces
    ``optax.warmup_cosine_decay_schedule(0, lr, max(steps // 20, 10), steps,
    lr * 0.01)`` at every update (the first update at lr 0)."""
    warmup = max(steps // 20, 10)
    decay = steps - warmup
    alpha = 0.01

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        t = min(count - warmup, decay)
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha

    return factor


def netvlad_update(model: MobileNetVLAD, opt: torch.optim.Optimizer,
                   imgs: torch.Tensor, temperature: float = 0.1
                   ) -> torch.Tensor:
    """One Adam step on ``ntxent_loss`` of (2n, 1, vh, vw) paired views;
    returns the loss (on device)."""
    opt.zero_grad(set_to_none=True)
    loss = ntxent_loss(model(imgs), temperature)
    loss.backward()
    opt.step()
    return loss.detach()


def save_resume(path: str, model: MobileNetVLAD,
                opt: torch.optim.Optimizer) -> None:
    """Atomic f32 snapshot of the parameters and Adam's state, by name."""
    out = {f"param/{k}": v.detach().cpu().numpy()
           for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            out[f"exp_avg/{name}"] = st["exp_avg"].cpu().numpy()
            out[f"exp_avg_sq/{name}"] = st["exp_avg_sq"].cpu().numpy()
            out[f"step/{name}"] = np.asarray(float(st["step"]))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)


def load_resume(path: str, model: MobileNetVLAD,
                opt: torch.optim.Optimizer) -> int:
    """Inverse of ``save_resume``, into a model and its fresh Adam; returns
    the number of updates the snapshot had taken."""
    raw = np.load(path)
    dev = next(model.parameters()).device
    model.load_state_dict({k[len("param/"):]: torch.from_numpy(raw[k])
                           for k in raw.files if k.startswith("param/")})
    for name, p in model.named_parameters():
        if f"step/{name}" in raw.files:
            opt.state[p] = {
                "step": torch.tensor(float(raw[f"step/{name}"])),
                "exp_avg": torch.from_numpy(raw[f"exp_avg/{name}"]).to(dev),
                "exp_avg_sq": torch.from_numpy(
                    raw[f"exp_avg_sq/{name}"]).to(dev)}
    steps = [int(raw[k]) for k in raw.files if k.startswith("step/")]
    return max(steps, default=0)


def load_netvlad(params, encoder_version: int, seed: int,
                 device) -> MobileNetVLAD:
    """The bundled MobileNetVLAD architecture on ``device`` holding
    ``params``, or Flax's default initialisation drawn from a generator
    seeded with ``seed``."""
    if params is None:
        model = init_mobilenetvlad(torch.Generator().manual_seed(seed),
                                   encoder_version)
    else:
        model = MobileNetVLAD(BUNDLED_CLUSTERS, BUNDLED_OUT_DIM, False,
                              encoder_version)
        model.load_state_dict(as_state(model_state(params)))
    return model.to(device)


def train_netvlad(*, steps: int = 600, places_per_batch: int = 16,
                  pool_size: int = 256, lr: float = 3e-4, seed: int = 0,
                  view: Tuple[int, int] = (96, 160), log_every: int = 50,
                  params=None, temperature: float = 0.1,
                  max_rot: float = 0.25, noise: float = 0.03,
                  scale: Tuple[float, float] = (1.0, 1.0),
                  cosine: bool = False, verbose: bool = False,
                  revisit_offset: Optional[float] = None,
                  save_every: Optional[int] = None,
                  save_path: Optional[str] = None,
                  resume_path: Optional[str] = None,
                  encoder_version: int = 1,
                  textured: bool = False, device="cuda"):
    """Train MobileNetVLAD (the bundled architecture). Returns (params,
    history of (step, loss)).

    The place pool renders once on the host and is uploaded; each step
    samples ``places_per_batch`` places on the host (``np.random``, seed + 1,
    as the reference) and renders both views on the device. With
    ``revisit_offset=f`` the two crop centres of a place lie within
    f * (vh, vw) of each other. ``cosine`` warms up and decays the rate as
    ``warmup_cosine``. Every ``save_every`` steps (and at the last) the f16
    checkpoint goes to ``save_path`` and, with ``resume_path``, the f32
    parameters and Adam's state to that sidecar, which a later call with
    the same ``resume_path`` resumes from.
    """
    dev = resolve_device(device)
    vh, vw = view
    pool = PlacePool(pool_size, view=view, seed=seed, textured=textured)
    places = torch.from_numpy(np.stack(pool.places)).to(dev)
    model = load_netvlad(params, encoder_version, seed, dev)
    opt = adam(model, lr)
    done = 0
    if resume_path is not None and os.path.exists(resume_path):
        done = load_resume(resume_path, model, opt)
    sched = None
    if cosine:
        factor = warmup_cosine(steps)
        # a resumed schedule goes on from the updates already taken
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: factor(count + done))
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed + 1)
    history = []
    for it in range(steps):
        idx = torch.from_numpy(rng.choice(pool_size, size=places_per_batch,
                                          replace=False)).to(dev)
        ca = cb = None
        if revisit_offset is not None:
            ca, cb = revisit_centers(places, places_per_batch, vh, vw,
                                     revisit_offset, gen)
        views = [device_render_views(
            places, idx, view_draws(places_per_batch, vh, vw, gen,
                                    max_rot=max_rot, scale=scale),
            vh, vw, noise=noise, centers=ctr) for ctr in (ca, cb)]
        loss = netvlad_update(model, opt, torch.cat(views, 0), temperature)
        if sched is not None:
            sched.step()
        if it % log_every == 0 or it == steps - 1:
            history.append((it, float(loss)))
            if verbose:
                print(f"step {it:5d} loss {float(loss):.4f}", flush=True)
        if (save_every and save_path and it > 0
                and (it % save_every == 0 or it == steps - 1)):
            tmp = save_path + ".tmp.npz"
            save_netvlad_npz(model.state_dict(), tmp,
                             encoder_version=encoder_version)
            os.replace(tmp, save_path)
            if resume_path is not None:
                save_resume(resume_path, model, opt)
    return state_of(model), history


def retrieval_metrics(params, *, n_places: int = 64, seed: int = 123,
                      view: Tuple[int, int] = (96, 160),
                      batch: int = 32, max_rot: float = 0.25,
                      noise: float = 0.03,
                      scale: Tuple[float, float] = (1.0, 1.0),
                      revisit_offset: Optional[float] = None,
                      encoder_version: int = 1,
                      textured: bool = False, device="cuda"):
    """recall@1 and similarity margin of held-out places: a query view of
    each place against one gallery view of every place, ranked by the dense
    ``argmax(dq @ dg.T)`` on the host. ``revisit_offset`` puts the query's
    crop centre within that fraction of the view size of the gallery's
    (the hard revisit tier: max_rot 0.5, noise 0.06, scale (0.8, 1.25),
    revisit_offset 0.35)."""
    dev = resolve_device(device)
    model = load_netvlad(params, encoder_version, 0, dev).eval()
    pool = PlacePool(n_places, seed=seed, view=view, textured=textured)
    vh, vw = view
    gal = np.zeros((n_places, vh, vw, 1), np.float32)
    qry = np.zeros((n_places, vh, vw, 1), np.float32)
    for i, p in enumerate(pool.places):
        gal[i, :, :, 0], c = render_view(pool.rng, p, vh, vw,
                                         max_rot=max_rot, noise=noise,
                                         scale=scale, return_center=True)
        qc = None
        if revisit_offset is not None:
            qc = (c[0] + pool.rng.uniform(-1, 1) * revisit_offset * vh,
                  c[1] + pool.rng.uniform(-1, 1) * revisit_offset * vw)
        qry[i, :, :, 0] = render_view(pool.rng, p, vh, vw, max_rot=max_rot,
                                      noise=noise, scale=scale, center=qc)

    def descs(imgs):
        with torch.no_grad():
            return np.concatenate([
                model(to_images(imgs[i:i + batch], dev)).cpu().numpy()
                for i in range(0, len(imgs), batch)], 0)

    dg = descs(gal)
    dq = descs(qry)
    sim = dq @ dg.T                                       # (Q, G)
    top1 = np.argmax(sim, axis=1)
    recall1 = float(np.mean(top1 == np.arange(n_places)))
    pos = np.diag(sim)
    neg = sim - 2.0 * np.eye(n_places)
    margin = float(np.mean(pos - neg.max(axis=1)))
    return {"recall_at_1": recall1, "mean_margin": margin,
            "mean_pos_sim": float(pos.mean()),
            "mean_top_neg_sim": float(neg.max(axis=1).mean())}
