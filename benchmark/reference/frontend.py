"""Plain reference of a keyframe step of the swarm's visual front-end.

For a batch of stereo pairs (every drone's 4 directions): SuperPoint
(DeTone et al., 2018) on every view, its heat map through window-max
non-maximum suppression, the detection threshold and a top-K cut to
keypoints refined to the heat-weighted centroid of their 3 x 3
neighbourhood, descriptors sampled bilinearly from the 1/8-resolution map
and projected by the checkpoint's PCA; MobileNetVLAD v2 with NetVLAD
pooling on the left views; mutual nearest-neighbour matching of the left
and right descriptors and midpoint triangulation of the matches; each
drone's keyframe merged from its 4 directions. Then top-1 retrieval of
each keyframe's global descriptor against a place database.

The weights are read from the bundled checkpoint files (Flax layout) with
numpy, and every layer is written here with ``torch.nn.functional``; the
outputs leave the device rounded to float16, the wire format the
configuration states. Runs in float32 in whatever matrix-product and
convolution precision is in force (the judge turns TF32 off; the control
turns it on).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

CAM_TO_BODY = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
VIEW_YAWS = (0.0, np.pi / 2, np.pi, -np.pi / 2)
SP_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
            "conv4a", "conv4b")
NV_BLOCK_STRIDES = (1, 2, 1, 2, 1, 2, 1)
GN_EPS = 1e-6


def load_weights(path, device) -> Dict[str, torch.Tensor]:
    """Every array of a checkpoint, f32 on ``device``; conv kernels from
    HWIO to OIHW, dense kernels transposed."""
    raw = np.load(path)
    out = {}
    for k in raw.files:
        if k == "__encoder_version":
            continue
        v = np.asarray(raw[k], np.float32)
        if k.endswith("/kernel"):
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        name = k[2:] if k.startswith("__") else k.replace("params/", "", 1)
        out[name] = torch.tensor(np.ascontiguousarray(v), device=device)
    return out


def superpoint(w, img):
    """(heat (B, H, W), unit descriptor map (B, H/8, W/8, 256))."""
    x = img
    for i, name in enumerate(SP_CONVS):
        x = F.relu(F.conv2d(x, w[f"{name}/kernel"], w[f"{name}/bias"],
                            padding=1))
        if i in (1, 3, 5):
            x = F.max_pool2d(x, 2)
    pa = F.relu(F.conv2d(x, w["convPa/kernel"], w["convPa/bias"], padding=1))
    logits = F.conv2d(pa, w["convPb/kernel"], w["convPb/bias"])
    prob = torch.softmax(logits, 1)[:, :64]
    B, _, hc, wc = prob.shape
    heat = prob.reshape(B, 8, 8, hc, wc).permute(0, 3, 1, 4, 2).reshape(
        B, hc * 8, wc * 8)
    da = F.relu(F.conv2d(x, w["convDa/kernel"], w["convDa/bias"], padding=1))
    desc = F.conv2d(da, w["convDb/kernel"], w["convDb/bias"])
    desc = desc / torch.clamp_min(desc.norm(dim=1, keepdim=True), 1e-8)
    return heat, desc.permute(0, 2, 3, 1)


def nms_candidates(heat, radius: int, threshold: float):
    """Scores that survive window-max suppression and the threshold (0
    elsewhere), (B, H*W) flat."""
    win = F.max_pool2d(heat[:, None], 2 * radius + 1, stride=1,
                       padding=radius)[:, 0]
    keep = (heat >= win) & (heat > threshold)
    return torch.where(keep, heat, 0.0).reshape(heat.shape[0], -1)


def keypoints(heat, k: int, radius: int, threshold: float):
    """(xy (B, k, 2), scores (B, k), valid (B, k), sorted candidate scores
    (B, k + 1)): the k best candidates, ties to the lower flat index,
    refined to the heat-weighted 3 x 3 centroid."""
    B, H, W = heat.shape
    cand = nms_candidates(heat, radius, threshold)
    scores, idx = torch.sort(cand, dim=1, descending=True, stable=True)
    ranked = scores[:, :k + 1]
    scores, idx = scores[:, :k], idx[:, :k]
    y, x = idx // W, idx % W
    num_x = torch.zeros(scores.shape, device=heat.device)
    num_y, den = torch.zeros_like(num_x), torch.zeros_like(num_x)
    flat = heat.reshape(B, -1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yi, xi = torch.clamp(y + dy, 0, H - 1), torch.clamp(x + dx, 0,
                                                              W - 1)
            wgt = torch.clamp_min(torch.gather(flat, 1, yi * W + xi), 0.0)
            num_x, num_y = num_x + wgt * (x + dx), num_y + wgt * (y + dy)
            den = den + wgt
    den = torch.clamp_min(den, 1e-12)
    xy = torch.stack([torch.clamp(num_x / den, 0, W - 1),
                      torch.clamp(num_y / den, 0, H - 1)], -1)
    return xy, scores, scores > threshold, ranked


def sample_descriptors(dmap, xy, pca_c, pca_m):
    """Bilinear samples of the (B, Hc, Wc, C) map at pixel coords xy, pixel
    centres at ((x + 0.5) / 8 - 0.5), edges clamped; unit, PCA, unit."""
    B, hc, wc, _ = dmap.shape
    gx = (xy[..., 0] + 0.5) / 8 - 0.5
    gy = (xy[..., 1] + 0.5) / 8 - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = (gx - x0)[..., None], (gy - y0)[..., None]
    b = torch.arange(B, device=dmap.device)[:, None]

    def at(yy, xx):
        return dmap[b, torch.clamp(yy.long(), 0, hc - 1),
                    torch.clamp(xx.long(), 0, wc - 1)]

    d = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
         + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1)))
    unit = lambda v: v / torch.clamp_min(v.norm(dim=-1, keepdim=True), 1e-8)
    return unit((unit(d) - pca_m) @ pca_c.T)


def _same_pad(x, k: int, s: int):
    """Flax/XLA 'SAME' padding of an NCHW input for a k x k, stride-s
    convolution (the lower side takes the smaller half)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def netvlad(w, img):
    """MobileNetVLAD v2 (GroupNorm blocks) + NetVLAD: (B, K * 512) unit."""
    def gn(x, name, groups):
        return F.relu(F.group_norm(x, groups, w[f"{name}/scale"],
                                   w[f"{name}/bias"], eps=GN_EPS))

    x = gn(F.conv2d(_same_pad(img, 3, 2), w["encoder/stem/kernel"],
                    stride=2), "encoder/stem_gn", 8)
    for i, s in enumerate(NV_BLOCK_STRIDES):
        p = f"encoder/sep{i}"
        cin = x.shape[1]
        x = gn(F.conv2d(_same_pad(x, 3, s), w[f"{p}/dw/kernel"], stride=s,
                        groups=cin), f"{p}/dw_gn", min(32, cin))
        x = F.conv2d(x, w[f"{p}/pw/kernel"])
        x = gn(x, f"{p}/pw_gn", min(32, x.shape[1]))
    B, C = x.shape[:2]
    feats = x.reshape(B, C, -1).transpose(1, 2)
    assign = torch.softmax(feats @ w["vlad/assign/kernel"].T
                           + w["vlad/assign/bias"], -1)
    vlad = assign.transpose(1, 2) @ feats - assign.sum(1)[..., None] \
        * w["vlad/centroids"][None]
    unit = lambda v: v / torch.clamp_min(v.norm(dim=-1, keepdim=True), 1e-8)
    return unit(unit(vlad).reshape(B, -1))


def mutual_matches(da, db, va, vb, min_sim: float):
    """(index in b, mask): mutual nearest neighbours above ``min_sim``,
    first index among equal maxima."""
    sim = da @ db.transpose(1, 2)
    sim = torch.where(va[:, :, None] & vb[:, None, :], sim, float("-inf"))
    best_b, best_a = sim.argmax(2), sim.argmax(1)
    best = torch.gather(sim, 2, best_b[..., None])[..., 0]
    k = torch.arange(da.shape[1], device=da.device)
    mutual = torch.gather(best_a, 1, best_b) == k
    return best_b, mutual & (best > min_sim) & va


def triangulate(ba, bb, baseline: float):
    """Midpoint of the rays from (0, 0, 0) along ba and from (baseline, 0,
    0) along bb; (points, RMS distance of the point to the two rays)."""
    eye = torch.eye(3, device=ba.device)
    pa = eye - ba[..., :, None] * ba[..., None, :]
    pb = eye - bb[..., :, None] * bb[..., None, :]
    ob = torch.zeros_like(bb)
    ob[..., 0] = baseline
    rhs = (pb @ ob[..., None])
    pts = torch.linalg.solve_ex(pa + pb + 1e-9 * eye, rhs)[0][..., 0]

    def dist2(p, o, d):
        v = p - o
        perp = v - torch.sum(v * d, -1, keepdim=True) * d
        return torch.sum(perp * perp, -1)

    err = torch.sqrt(0.5 * (dist2(pts, torch.zeros_like(pts), ba)
                            + dist2(pts, ob, bb)))
    return pts, err


class StepOut(NamedTuple):
    """Per left view (B = drones x 4): float16 keypoints, descriptors,
    global descriptors and body-frame landmarks, as the wire carries them;
    the landmark and keypoint validity; and the reference's ranked
    candidate scores and heat maps, which judge another's keypoints."""
    xy: np.ndarray          # (B, K, 2) f16
    desc: np.ndarray        # (B, K, C) f16
    gdesc: np.ndarray       # (B, G) f16
    pts: np.ndarray         # (B, K, 3) f16
    ok: np.ndarray          # (B, K) bool
    kp_valid: np.ndarray    # (B, K) bool
    ranked: np.ndarray      # (B, K + 1) f32: best candidate scores
    heat: np.ndarray        # (B, H, W) f32 heat maps


@torch.no_grad()
def step(sp, nv, fp: dict, lefts: np.ndarray, rights: np.ndarray,
         device) -> StepOut:
    """The reference's keyframe batch on (B, H, W) uint8 left and right
    views."""
    B, H, W = lefts.shape
    imgs = torch.tensor(np.concatenate([lefts, rights]), device=device)
    imgs = imgs[:, None].float() / 255.0
    heat, dmap = superpoint(sp, imgs)
    K, r, thr = fp["max_keypoints"], fp["nms_dist"], fp["superpoint_thres"]
    xy, _scores, valid, ranked = keypoints(heat, K, r, thr)
    desc = sample_descriptors(dmap, xy, sp["pca_components"],
                              sp["pca_mean"])
    gdesc = netvlad(nv, imgs[:B])
    idx_b, mask = mutual_matches(desc[:B], desc[B:], valid[:B], valid[B:],
                                 0.5)
    xy_r = torch.gather(xy[B:], 1, idx_b[..., None].expand(-1, -1, 2))

    def bearing(p):
        ray = torch.stack([(p[..., 0] - W / 2) / fp["fx"],
                           (p[..., 1] - H / 2) / fp["fy"],
                           torch.ones_like(p[..., 0])], -1)
        return ray / ray.norm(dim=-1, keepdim=True)

    pts, err = triangulate(bearing(xy[:B]), bearing(xy_r), fp["baseline_m"])
    depth = pts[..., 2]
    finite = torch.isfinite(pts).all(-1)
    ok = (mask & finite & (err < fp["triangulate_max_err"]) & (depth > 0.3)
          & (depth < 30.0))
    pts = torch.where(finite[..., None], pts, 0.0)
    body = torch.where(ok[..., None], pts @ torch.tensor(
        CAM_TO_BODY, device=device).T, 0.0)
    h16 = lambda t: t.to(torch.float16).cpu().numpy()
    return StepOut(h16(xy[:B]), h16(desc[:B]), h16(gdesc), h16(body),
                   ok.cpu().numpy(), valid[:B].cpu().numpy(),
                   ranked[:B].cpu().numpy(), heat[:B].cpu().numpy())


def merge(out: StepOut, drones: int):
    """Each drone's keyframe from its 4 directions (as the wire carries
    them): (xy, desc, landmarks yawed into the body frame, landmark
    validity, unit mean global descriptor), float32 numpy."""
    kfs = []
    for d in range(drones):
        rows = range(4 * d, 4 * d + 4)
        xy = np.concatenate([out.xy[i] for i in rows]).astype(np.float32)
        desc = np.concatenate([out.desc[i] for i in rows]).astype(np.float32)
        lms = []
        for v, i in enumerate(rows):
            p = out.pts[i].astype(np.float32)
            c, s = np.cos(VIEW_YAWS[v]), np.sin(VIEW_YAWS[v])
            q = p.copy()
            q[:, 0] = c * p[:, 0] - s * p[:, 1]
            q[:, 1] = s * p[:, 0] + c * p[:, 1]
            lms.append(q)
        g = out.gdesc[list(rows)].astype(np.float32)
        g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-8)
        gd = g.mean(0)
        gd = gd / max(np.linalg.norm(gd), 1e-8)
        kfs.append((xy, desc, np.concatenate(lms).astype(np.float32),
                    np.concatenate([out.ok[i] for i in rows]),
                    gd.astype(np.float32)))
    return kfs


def top1(db: torch.Tensor, usable: torch.Tensor, q: torch.Tensor):
    """(index, similarity) of each query's best usable row, the lowest
    index among equal maxima; (0, -inf) when none is usable."""
    sims = torch.where(usable, q @ db.T, float("-inf"))
    best = sims.argmax(1)
    return best, torch.gather(sims, 1, best[:, None])[:, 0]
