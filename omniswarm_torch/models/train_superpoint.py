"""SuperPoint training on synthetic imagery: the MagicPoint and photometric
stages, on the card.

Counterpart of ``omniswarm_tpu/models/train_superpoint.py``:

- the host renderers (``render_textured``, ``render_mixed``, ``make_batch``,
  ``make_batch_textured``, ``make_warped_pairs``, ``corner_label_map``) are
  numpy copies that reuse ``sim/image_world.py::render_shapes``: the same
  ``np.random.Generator`` state gives bit-identical images and labels;
- ``homographic_adaptation_labels`` runs the detector on the device under
  ``no_grad`` and accumulates the warped-back heat maps on the host with
  ``np.add.at``, as the reference does;
- the losses are the reference's 65-way detector cross-entropy (corner
  cells weighted 10x) and its symmetric dense InfoNCE over warped cell
  correspondences; their gradients come from autograd through
  ``nn.Conv2d`` (the reference differentiates XLA convolutions);
- ``torch.optim.Adam(lr)`` stands in for ``optax.adam(lr)``;
- the metrics extract keypoints through ``ops/keypoints.py``, so K2
  (``csrc/grid_nms.cu``) runs on CUDA tensors.

Images are (B, H, W, 1) float32 numpy arrays on the host, as the reference
renders them, and (B, 1, H, W) tensors on the device. The networks'
parameters travel as ``SuperPoint`` state dicts (``conv1a.weight`` ...),
optionally with ``pca_components`` / ``pca_mean``; an extractor's state
dict (``net.conv1a.weight`` ...) is accepted as well.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.models.superpoint import (SuperPoint,
                                               SuperPointExtractor, _unit,
                                               init_superpoint, net_state)
from omniswarm_torch.ops.keypoints import (bilinear_sample_descriptors,
                                           extract_keypoints)
from omniswarm_torch.ops.matching import mutual_match
from omniswarm_torch.sim.image_world import render_shapes


# ---------------------------------------------------------------------------
# Synthetic rendering (host-side numpy)
# ---------------------------------------------------------------------------

def _multiscale_noise(rng, h, w, octaves=4):
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        base = rng.normal(0, 1.0 / (o + 1), size=(sh, sw)).astype(np.float32)
        ys = np.linspace(0, sh - 1, h)
        xs = np.linspace(0, sw - 1, w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, sh - 1)
        x1 = np.minimum(x0 + 1, sw - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        img += (base[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
                + base[np.ix_(y1, x0)] * fy * (1 - fx)
                + base[np.ix_(y0, x1)] * (1 - fy) * fx
                + base[np.ix_(y1, x1)] * fy * fx)
    img -= img.min()
    return img / max(img.max(), 1e-6)


def _fill_polygon(img, pts, tex):
    """Fill a convex polygon with the given texture patch values."""
    h, w = img.shape
    ys, xs = np.mgrid[:h, :w]
    inside = np.ones((h, w), bool)
    n = len(pts)
    cx, cy = pts[:, 0].mean(), pts[:, 1].mean()
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        crossz = (x1 - x0) * (ys - y0) - (y1 - y0) * (xs - x0)
        side = (x1 - x0) * (cy - y0) - (y1 - y0) * (cx - x0)
        inside &= (crossz * np.sign(side)) >= 0
    img[inside] = tex[inside]
    return img


def render_textured(rng: np.random.Generator, h: int, w: int,
                    n_shapes: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """(image (h, w) in [0, 1], corners (K, 2) [x, y]): convex textured
    polygons over multi-scale noise, then exposure gradient, gamma,
    brightness/contrast jitter, an optional box blur and sensor noise."""
    img = _multiscale_noise(rng, h, w) * rng.uniform(0.25, 0.55)
    corners = []
    for _ in range(n_shapes):
        nv = int(rng.integers(3, 6))
        cx, cy = rng.uniform(8, w - 8), rng.uniform(8, h - 8)
        r = rng.uniform(5, min(h, w) / 3)
        angs = np.sort(rng.uniform(0, 2 * np.pi, nv))
        pts = np.stack([cx + r * np.cos(angs), cy + r * np.sin(angs)], 1)
        pts[:, 0] = np.clip(pts[:, 0], 1, w - 2)
        pts[:, 1] = np.clip(pts[:, 1], 1, h - 2)
        tex = _multiscale_noise(rng, h, w)
        lo, hi = np.sort(rng.uniform(0.0, 1.0, 2))
        tex = lo + tex * max(hi - lo, 0.25)
        img = _fill_polygon(img, pts, tex)
        corners.extend(pts)
    gx = np.linspace(-1, 1, w)[None, :] * rng.uniform(-0.15, 0.15)
    gy = np.linspace(-1, 1, h)[:, None] * rng.uniform(-0.15, 0.15)
    img = img + gx + gy                         # exposure gradient
    img = np.clip(img, 0, 1) ** rng.uniform(0.7, 1.4)   # gamma
    img = (img - 0.5) * rng.uniform(0.7, 1.3) + rng.uniform(0.35, 0.6)
    if rng.uniform() < 0.5:                     # box blur (defocus/motion)
        k = 1
        img = (img
               + np.roll(img, k, 0) + np.roll(img, -k, 0)
               + np.roll(img, k, 1) + np.roll(img, -k, 1)) / 5.0
    img = img + rng.normal(0, rng.uniform(0.01, 0.05), img.shape)
    img = np.clip(img, 0, 1).astype(np.float32)
    return img, np.asarray(corners, np.float32)


def render_mixed(rng: np.random.Generator, h: int, w: int,
                 textured_frac: float = 0.75):
    """Textured surfaces most of the time, line art otherwise."""
    if rng.uniform() < textured_frac:
        return render_textured(rng, h, w)
    return render_shapes(rng, h, w, n_shapes=6)


def corner_label_map(corners: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h/8, w/8) int labels in [0, 64]: cell-local corner index or 64."""
    hc, wc = h // 8, w // 8
    lab = np.full((hc, wc), 64, np.int32)      # dustbin
    for x, y in corners:
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < w and 0 <= yi < h:
            lab[yi // 8, xi // 8] = (yi % 8) * 8 + (xi % 8)
    return lab


def _labelled_batch(render, rng, batch: int, h: int, w: int):
    imgs = np.zeros((batch, h, w, 1), np.float32)
    labs = np.zeros((batch, h // 8, w // 8), np.int32)
    for b in range(batch):
        img, corners = render(rng, h, w)
        imgs[b, :, :, 0] = img
        labs[b] = corner_label_map(corners, h, w)
    return imgs, labs


def make_batch(rng, batch: int, h: int, w: int):
    """Line-art images (B, h, w, 1) and their corner labels (B, h/8, w/8)."""
    return _labelled_batch(render_shapes, rng, batch, h, w)


def make_batch_textured(rng, batch: int, h: int, w: int):
    """Textured images (B, h, w, 1) and their corner labels."""
    return _labelled_batch(render_textured, rng, batch, h, w)


def _inverse_warp(img, xs, ys, c, s, zoom, tx, ty):
    """Bilinear sample of ``img`` at the source pixels of a rotation + zoom
    about the centre plus a shift; returns (values, (xa, ya))."""
    h, w = img.shape
    cx, cy = w / 2.0, h / 2.0
    xb = xs - cx - tx
    yb = ys - cy - ty
    z2 = zoom * zoom
    xa = (c * xb + s * yb) / z2 + cx
    ya = (-s * xb + c * yb) / z2 + cy
    x0 = np.clip(np.floor(xa).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(ya).astype(int), 0, h - 2)
    fx = np.clip(xa - x0, 0, 1)
    fy = np.clip(ya - y0, 0, 1)
    v = (img[y0, x0] * (1 - fy) * (1 - fx)
         + img[y0 + 1, x0] * fy * (1 - fx)
         + img[y0, x0 + 1] * (1 - fy) * fx
         + img[y0 + 1, x0 + 1] * fy * fx)
    return v, (xa, ya)


def make_warped_pairs(rng, batch: int, h: int, w: int, *,
                      max_rot: float = 0.3, max_shift: float = 12.0,
                      scale=(1.0, 1.0), render_fn=None):
    """(imgs_a, imgs_b (B, h, w, 1), T_ba (B, 2, 3)): image B is image A
    resampled under a rotation and zoom about the centre plus a shift, with
    its own gain and noise; p_b = T_ba[:, :2] @ p_a + T_ba[:, 2]."""
    imgs_a = np.zeros((batch, h, w, 1), np.float32)
    imgs_b = np.zeros((batch, h, w, 1), np.float32)
    T_ba = np.zeros((batch, 2, 3), np.float32)
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    for b in range(batch):
        if render_fn is None:
            img, _ = render_shapes(rng, h, w, n_shapes=6)
        else:
            img, _ = render_fn(rng, h, w)
        imgs_a[b, :, :, 0] = img
        ang = rng.uniform(-max_rot, max_rot)
        zoom = rng.uniform(*scale)
        tx = rng.uniform(-max_shift, max_shift)
        ty = rng.uniform(-max_shift, max_shift)
        c, s = np.cos(ang) * zoom, np.sin(ang) * zoom
        cx, cy = w / 2.0, h / 2.0
        T_ba[b] = [[c, -s, cx - c * cx + s * cy + tx],
                   [s, c, cy - s * cx - c * cy + ty]]
        v, (xa, ya) = _inverse_warp(img, xs, ys, c, s, zoom, tx, ty)
        inside = (xa >= 0) & (xa < w - 1) & (ya >= 0) & (ya < h - 1)
        v = np.where(inside, v, 0.0)
        gain = rng.uniform(0.8, 1.2)
        v = np.clip(v * gain + rng.normal(0, 0.02, v.shape), 0, 1)
        imgs_b[b, :, :, 0] = v
    return imgs_a, imgs_b, T_ba


def to_images(imgs: np.ndarray, device) -> torch.Tensor:
    """Host (B, H, W, 1) images as a (B, 1, H, W) f32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        imgs[..., 0], np.float32))[:, None].to(device)


def homographic_adaptation_labels(model: SuperPoint, imgs: np.ndarray,
                                  rng: np.random.Generator, *,
                                  n_warps: int = 8,
                                  threshold: float = 0.15) -> np.ndarray:
    """Self-label a batch by averaging the detector's heat maps over warps.

    The current ``model`` (on its device, no gradient) sees ``n_warps``
    warped copies of each image (the first unwarped); each heat map is
    scattered back to its source pixels on the host, averaged and
    thresholded into the per-cell 65-way label format.
    """
    dev = next(model.parameters()).device
    B, h, w, _ = imgs.shape
    acc = np.zeros((B, h, w), np.float32)
    cnt = np.zeros((B, h, w), np.float32) + 1e-6
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    for k in range(n_warps):
        if k == 0:
            warped = imgs
            maps = None
        else:
            ang = rng.uniform(-0.4, 0.4)
            zoom = rng.uniform(0.85, 1.2)
            tx = rng.uniform(-8, 8)
            ty = rng.uniform(-8, 8)
            c, s = np.cos(ang) * zoom, np.sin(ang) * zoom
            warped = np.zeros_like(imgs)
            for b in range(B):
                warped[b, :, :, 0], maps = _inverse_warp(
                    imgs[b, :, :, 0], xs, ys, c, s, zoom, tx, ty)
        with torch.no_grad():
            heat, _ = model(to_images(warped, dev))
        heat = heat.cpu().numpy()
        if maps is None:
            acc += heat
            cnt += 1.0
        else:
            xa, ya = maps
            inside = (xa >= 0) & (xa < w - 1) & (ya >= 0) & (ya < h - 1)
            # heat at warped pixel (xa, ya) belongs to source pixel (x, y)
            xi = np.clip(np.round(xa).astype(int), 0, w - 1)
            yi = np.clip(np.round(ya).astype(int), 0, h - 1)
            for b in range(B):
                np.add.at(acc[b], (yi[inside], xi[inside]),
                          heat[b][inside])
                np.add.at(cnt[b], (yi[inside], xi[inside]), 1.0)
    mean = acc / cnt
    hc, wc = h // 8, w // 8
    labs = np.full((B, hc, wc), 64, np.int32)
    for b in range(B):
        cells = mean[b][:hc * 8, :wc * 8].reshape(hc, 8, wc, 8).transpose(
            0, 2, 1, 3).reshape(hc, wc, 64)
        labs[b] = np.where(cells.max(-1) >= threshold, cells.argmax(-1), 64)
    return labs


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def detector_loss(model: SuperPoint, imgs: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """65-way per-cell softmax cross-entropy on the raw detector logits;
    corner cells (label < 64) weigh 10x the dustbin cells."""
    _, _, logits = model(imgs, return_logits=True)    # (B, hc, wc, 65)
    logp = torch.log_softmax(logits, dim=-1)
    logp_true = torch.gather(logp, -1, labels[..., None])[..., 0]
    w_pos = torch.where(labels < 64, 10.0, 1.0)
    return -torch.sum(w_pos * logp_true) / torch.sum(w_pos)


def cell_correspondences(T_ba: torch.Tensor, h: int, w: int):
    """Warped cell correspondences of ``descriptor_loss``: (tgt, ok) for
    A -> B and (tgt_b, ok_b) for B -> A, each (B, Hc * Wc).

    An A-cell's target is the B-cell centre nearest its warped centre, valid
    within 4 px and inside the image; a B-cell's is the A-cell whose warped
    centre lands nearest it. ``argmin`` keeps the first of equal distances,
    as ``jnp.argmin`` does.
    """
    hc, wc = h // 8, w // 8
    ys, xs = torch.meshgrid(torch.arange(hc, device=T_ba.device),
                            torch.arange(wc, device=T_ba.device),
                            indexing="ij")
    ctr = torch.stack([xs * 8.0 + 4.0, ys * 8.0 + 4.0], -1).reshape(-1, 2)
    warped = (torch.einsum("bij,nj->bni", T_ba[:, :, :2], ctr)
              + T_ba[:, None, :, 2])                          # (B, Na, 2)
    inside = ((warped[..., 0] >= 0) & (warped[..., 0] < w)
              & (warped[..., 1] >= 0) & (warped[..., 1] < h))
    d2 = torch.sum((warped[:, :, None, :] - ctr[None, None]) ** 2, -1)
    tgt = torch.argmin(d2, dim=-1)                            # (B, Na)
    ok = inside & (torch.amin(d2, dim=-1) <= 16.0)            # within 4 px
    d2T = d2.transpose(1, 2)                                  # (B, Nb, Na)
    tgt_b = torch.argmin(d2T, dim=-1)
    ok_b = (torch.amin(d2T, dim=-1) <= 16.0) & torch.gather(inside, 1, tgt_b)
    return tgt, ok, tgt_b, ok_b


def _xent(logits, target, valid):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    vf = valid.to(nll.dtype)
    return torch.sum(nll * vf) / torch.clamp_min(torch.sum(vf), 1.0)


def descriptor_loss(model: SuperPoint, imgs_a: torch.Tensor,
                    imgs_b: torch.Tensor, T_ba: torch.Tensor, *,
                    temperature: float = 0.1) -> torch.Tensor:
    """Symmetric dense InfoNCE over warped cell correspondences: every
    valid A-cell must retrieve its B-cell among all B-cells of the same
    image (softmax over inner products / temperature), and B -> A."""
    B, _, h, w = imgs_a.shape
    _, da = model(imgs_a)                                     # (B,hc,wc,C)
    _, db = model(imgs_b)
    da = da.reshape(B, -1, da.shape[-1])
    db = db.reshape(B, -1, db.shape[-1])
    tgt, ok, tgt_b, ok_b = cell_correspondences(T_ba, h, w)
    dot = torch.einsum("bnc,bmc->bnm", da, db) / temperature
    loss_ab = _xent(dot, tgt, ok)
    loss_ba = _xent(dot.transpose(1, 2), tgt_b, ok_b)
    return 0.5 * (loss_ab + loss_ba)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def adam(model: torch.nn.Module, lr) -> torch.optim.Adam:
    """``torch.optim.Adam`` in place of ``optax.adam(lr)``: both update by
    -lr * m_hat / (sqrt(v_hat) + eps) with betas (0.9, 0.999), eps = 1e-8
    outside the square root (optax's eps_root = 0)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def as_state(params) -> Dict[str, torch.Tensor]:
    """``params`` (tensors or numpy arrays) as f32 tensors."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).float()
            for k, v in params.items()}


def load_superpoint(params: Optional[Dict], seed: int, device) -> SuperPoint:
    """A SuperPoint on ``device`` holding ``params``, or Flax's default
    initialisation drawn from a generator seeded with ``seed``."""
    if params is None:
        net = init_superpoint(torch.Generator().manual_seed(seed))
    else:
        net = SuperPoint()
        net.load_state_dict(as_state(net_state(params)))
    return net.to(device)


def state_of(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of ``model``'s state dict."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def detector_update(model: SuperPoint, opt: torch.optim.Optimizer,
                    imgs: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """One Adam step on ``detector_loss``; returns the loss (on device)."""
    opt.zero_grad(set_to_none=True)
    loss = detector_loss(model, imgs, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def joint_update(model: SuperPoint, opt: torch.optim.Optimizer,
                 imgs, labels, imgs_a, imgs_b, T_ba,
                 detector_weight: float = 1.0):
    """One Adam step on descriptor_loss + detector_weight * detector_loss;
    returns (loss, descriptor loss, detector loss) on device."""
    opt.zero_grad(set_to_none=True)
    ld = descriptor_loss(model, imgs_a, imgs_b, T_ba)
    lc = detector_loss(model, imgs, labels)
    loss = ld + detector_weight * lc
    loss.backward()
    opt.step()
    return loss.detach(), ld.detach(), lc.detach()


def train_detector(*, steps: int = 300, batch: int = 16, h: int = 64,
                   w: int = 96, lr: float = 1e-3, seed: int = 0,
                   log_every: int = 50, params=None, batch_fn=None,
                   ha_every: int = 0, ha_warps: int = 8,
                   start_step: int = 0, save_every: int = 0, save_fn=None,
                   log_fn=None, device="cuda"):
    """Train the detector head. Returns (params, history of (step, loss)).

    ``batch_fn(rng, batch, h, w) -> (imgs, labels)``: ``make_batch`` (the
    MagicPoint line-art stage, the default) or ``make_batch_textured`` (the
    photometric stage). ``ha_every`` > 0 replaces every ha_every-th batch's
    labels by ``homographic_adaptation_labels`` of the current model.
    ``save_fn(params, step)`` runs every ``save_every`` steps.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = load_superpoint(params, seed, dev)
    batch_fn = batch_fn or make_batch
    opt = adam(model, lr)
    history = []
    for it in range(start_step, steps):
        imgs, labels = batch_fn(rng, batch, h, w)
        if ha_every > 0 and it % ha_every == ha_every - 1:
            labels = homographic_adaptation_labels(model, imgs, rng,
                                                   n_warps=ha_warps)
        loss = detector_update(model, opt, to_images(imgs, dev),
                               torch.from_numpy(labels).long().to(dev))
        if it % log_every == 0 or it == steps - 1:
            history.append((it, float(loss)))
            if log_fn is not None:
                log_fn(history[-1])
        if save_fn is not None and save_every > 0 \
                and (it + 1) % save_every == 0:
            save_fn(state_of(model), it + 1)
    return state_of(model), history


def train_descriptors(*, steps: int = 500, batch: int = 8, h: int = 64,
                      w: int = 96, lr: float = 1e-3, seed: int = 0,
                      log_every: int = 50, params=None,
                      detector_weight: float = 1.0, batch_fn=None,
                      render_fn=None, max_rot: float = 0.3,
                      max_shift: float = 12.0, scale=(1.0, 1.0),
                      start_step: int = 0, save_every: int = 0,
                      save_fn=None, log_fn=None, device="cuda"):
    """Joint detector + descriptor training on warped pairs. Returns
    (params, history of (step, loss, descriptor loss, detector loss)).

    Each step renders a labelled batch (``batch_fn``) and a batch of warped
    pairs (``make_warped_pairs`` with ``render_fn``) from one
    ``np.random.Generator``, in the reference's order.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = load_superpoint(params, seed, dev)
    batch_fn = batch_fn or make_batch
    opt = adam(model, lr)
    history = []
    for it in range(start_step, steps):
        imgs, labels = batch_fn(rng, batch, h, w)
        ia, ib, T = make_warped_pairs(rng, batch, h, w, max_rot=max_rot,
                                      max_shift=max_shift, scale=scale,
                                      render_fn=render_fn)
        loss, ld, lc = joint_update(
            model, opt, to_images(imgs, dev),
            torch.from_numpy(labels).long().to(dev), to_images(ia, dev),
            to_images(ib, dev), torch.from_numpy(T).to(dev),
            detector_weight)
        if it % log_every == 0 or it == steps - 1:
            history.append((it, float(loss), float(ld), float(lc)))
            if log_fn is not None:
                log_fn(history[-1])
        if save_fn is not None and save_every > 0 \
                and (it + 1) % save_every == 0:
            save_fn(state_of(model), it + 1)
    return state_of(model), history


# ---------------------------------------------------------------------------
# PCA and metrics
# ---------------------------------------------------------------------------

def sample_raw_descriptors(params, *, n_images: int = 128, h: int = 64,
                           w: int = 96, seed: int = 3, top_k: int = 50,
                           render_fn=None, batch: int = 16,
                           device="cuda") -> np.ndarray:
    """Raw (pre-PCA) unit 256-d descriptors at the keypoints detected on
    ``n_images`` rendered images (``render_textured`` by default), batched
    ``batch`` at a time (K2 at (batch, h, w) on the card): the input of
    ``fit_pca``."""
    dev = resolve_device(device)
    model = load_superpoint(params, 0, dev).eval()
    rng = np.random.default_rng(seed)
    render_fn = render_fn or render_textured
    out = []
    for s in range(0, n_images, batch):
        nb = min(batch, n_images - s)
        imgs = np.zeros((batch, h, w, 1), np.float32)
        for b in range(nb):
            imgs[b, :, :, 0] = render_fn(rng, h, w)[0]
        with torch.no_grad():
            heat, dc = model(to_images(imgs, dev))
            xy, _, valid = extract_keypoints(heat, max_keypoints=top_k,
                                             threshold=0.015, nms_dist=4)
            desc = _unit(bilinear_sample_descriptors(dc, xy, cell=8), -1)
        desc, valid = desc.cpu().numpy(), valid.cpu().numpy()
        out.append(desc[:nb][valid[:nb]])
    return np.concatenate(out, 0)


def fit_pca(desc: np.ndarray, dim: int):
    """(components (dim, C), mean (C,), explained_ratio (dim,)) of a plain
    SVD of the centred descriptors (``tools/fit_pca.py::fit_pca``)."""
    desc = np.asarray(desc, np.float64)
    mean = desc.mean(axis=0)
    _, s, vt = np.linalg.svd(desc - mean, full_matrices=False)
    var = s ** 2
    ratio = var[:dim] / var.sum()
    return vt[:dim].astype(np.float32), mean.astype(np.float32), ratio


def jl_projection() -> torch.Tensor:
    """A seeded Johnson-Lindenstrauss 256 -> 64 projection, N(0, 1/256)
    entries, the stand-in for a fitted PCA. The reference draws its own
    with ``jax.random.normal(PRNGKey(0), (64, 256)) / 16``, which torch
    cannot reproduce; pass that matrix as ``projection`` to match it."""
    g = torch.Generator().manual_seed(0)
    return torch.randn(64, 256, generator=g) / 16.0


def matching_metrics(params, *, n_eval: int = 8, h: int = 64, w: int = 96,
                     seed: int = 77, top_k: int = 50, max_rot: float = 0.3,
                     max_shift: float = 12.0, scale=(1.0, 1.0),
                     render_fn=None, projection=None, device="cuda"):
    """Cross-warp matching precision on ``n_eval`` held-out pairs: detect
    in both views, mutual-match the PCA descriptors (similarity > 0.5) and
    count a match correct within 4 px of the warped truth. Without a PCA in
    ``params`` the descriptors go through ``projection`` (default
    ``jl_projection()``)."""
    dev = resolve_device(device)
    if "pca_components" in params:
        comps, mean = params["pca_components"], params["pca_mean"]
    else:
        comps = jl_projection() if projection is None else projection
        mean = np.zeros(256, np.float32)
    state = {f"net.{k}": v for k, v in net_state(params).items()}
    state["pca_components"], state["pca_mean"] = comps, mean
    state = {k: v.cpu() for k, v in as_state(state).items()}
    ex = SuperPointExtractor(state, max_keypoints=top_k, threshold=0.015,
                             nms_dist=4,
                             pca_dim=state["pca_components"].shape[0])
    ex = ex.to(dev).eval()
    rng = np.random.default_rng(seed)
    correct = total = 0
    for _ in range(n_eval):
        ia, ib, T = make_warped_pairs(rng, 1, h, w, max_rot=max_rot,
                                      max_shift=max_shift, scale=scale,
                                      render_fn=render_fn)
        xy_a, _, desc_a, va = ex(to_images(ia, dev))
        xy_b, _, desc_b, vb = ex(to_images(ib, dev))
        m = mutual_match(desc_a[0], desc_b[0], va[0], vb[0],
                         min_similarity=0.5)
        mask = m.mask.cpu().numpy()
        idx_b = m.idx_b.cpu().numpy()
        xa = xy_a[0].cpu().numpy()
        xb = xy_b[0].cpu().numpy()
        warped = xa @ T[0, :, :2].T + T[0, :, 2]
        for i in np.flatnonzero(mask):
            err = np.linalg.norm(warped[i] - xb[idx_b[i]])
            total += 1
            correct += bool(err < 4.0)
    return {"match_precision": correct / max(total, 1), "matches": total}


def detection_metrics(params, *, n_eval: int = 16, h: int = 64, w: int = 96,
                      seed: int = 1, top_k: int = 50, tol: float = 4.0,
                      device="cuda"):
    """Corner localisation precision and recall on ``n_eval`` held-out
    line-art images (a detection is a true positive within ``tol`` px of a
    corner not yet taken)."""
    dev = resolve_device(device)
    model = load_superpoint(params, 0, dev).eval()
    rng = np.random.default_rng(seed)
    tp = fp = fn = 0
    for _ in range(n_eval):
        img, corners = render_shapes(rng, h, w)
        with torch.no_grad():
            heat, _ = model(torch.from_numpy(img)[None, None].to(dev))
            xy, _, valid = extract_keypoints(heat, max_keypoints=top_k,
                                             threshold=0.015, nms_dist=4)
        det = xy[0][valid[0]].cpu().numpy()
        used = np.zeros(len(corners), bool)
        for x, y in det:
            if len(corners):
                d = np.linalg.norm(corners - np.asarray([x, y]), axis=1)
                j = int(np.argmin(d))
                if d[j] < tol and not used[j]:
                    used[j] = True
                    tp += 1
                    continue
            fp += 1
        fn += int((~used).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {"precision": precision, "recall": recall, "tp": tp, "fp": fp,
            "fn": fn}
