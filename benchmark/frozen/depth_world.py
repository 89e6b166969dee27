"""RGB-D frames of the frozen ``image_world.RoomWorld``: the infrared view
as ``RoomWorld.render`` draws it and a depth map as a RealSense z16 stream
carries it (uint16 millimetres), both from one seed, on the device.

Written for the benchmark's RGB-D cell, so that a change to the program
cannot change the frames it is fed. A pixel's depth is the ray parameter
of the nearest wall its ray hits, with the walls and the hit rule of
``RoomWorld.render``: the ray is ((u - w/2) / fx, (v - h/2) / fy, 1) in
the camera frame, so the parameter is the hit's camera-frame depth. The
sensor model (the configuration's ``depth`` group): Gaussian noise of
``noise_per_m2`` x z^2 metres (the depth error of an active stereo camera
grows with the square of the distance), rounding to millimetres, and holes
(0) in ``hole_share`` of each map's ``hole_block`` x ``hole_block`` pixel
blocks, drawn at random; a ray that meets no wall reads 0 as well.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen import image_world

U16_MAX = 65535


def wall_depth(world: image_world.RoomWorld, poses: torch.Tensor,
               fx: float, fy: float, h: int, w: int) -> torch.Tensor:
    """(V, h, w) float64 camera-frame depths of the camera poses (V, 4)
    float64 (x, y, z, yaw; the camera looks along body +x), inf where no
    wall is hit."""
    f64 = dict(dtype=torch.float64, device=poses.device)
    vs, us = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64),
                            indexing="ij")
    rays_cam = torch.stack([(us - w / 2) / fx, (vs - h / 2) / fy,
                            torch.ones_like(us)], -1)
    c, s = torch.cos(poses[:, 3]), torch.sin(poses[:, 3])
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    yaw = torch.stack([torch.stack([c, -s, zero], -1),
                       torch.stack([s, c, zero], -1),
                       torch.stack([zero, zero, one], -1)], -2)
    R = yaw @ torch.tensor(image_world.CAM_TO_BODY, **f64)
    rays_w = torch.einsum("hwj,vij->vhwi", rays_cam, R)
    pos = poses[:, None, None, :3]
    best = torch.full(rays_w.shape[:3], torch.inf, **f64)
    for p0, n, _e1 in world.specs:
        p0, n = torch.tensor(p0, **f64), torch.tensor(n, **f64)
        dn = rays_w @ n
        t = ((p0 - pos) @ n) / torch.where(dn.abs() < 1e-6, 1e-6, dn)
        best = torch.where((t > 0.05) & (t < best), t, best)
    return best


def sensor_depth(z: torch.Tensor, sensor: dict,
                 gen: torch.Generator) -> torch.Tensor:
    """(V, h, w) uint16 millimetres of true depths z (V, h, w) float64
    through the sensor model."""
    V, h, w = z.shape
    noisy = z + sensor["noise_per_m2"] * z * z * torch.randn(
        z.shape, generator=gen, dtype=torch.float64, device=z.device)
    mm = torch.where(torch.isfinite(noisy), torch.round(noisy * 1000.0), 0.0)
    mm = mm.clamp(0, U16_MAX).to(torch.int32)
    b = sensor["hole_block"]
    bh, bw = h // b, w // b
    holes = int(round(sensor["hole_share"] * bh * bw))
    picked = torch.rand((V, bh * bw), generator=gen, dtype=torch.float64,
                        device=z.device).argsort(1)[:, :holes]
    mask = torch.zeros((V, bh * bw), dtype=torch.bool, device=z.device)
    mask = mask.scatter(1, picked, True).reshape(V, bh, 1, bw, 1)
    mask = mask.expand(V, bh, b, bw, b).reshape(V, bh * b, bw * b)
    mm[:, :bh * b, :bw * b] = torch.where(mask, 0, mm[:, :bh * b, :bw * b])
    return mm


def render_rgbd(gt, frames, fx: float, fy: float, h: int, w: int,
                world: image_world.RoomWorld, sensor: dict, seed: int,
                device):
    """Per frame in ``frames``: every drone's (infrared uint8 (h, w), depth
    uint16 mm (h, w)) at its ground-truth pose ``gt[frame, drone]``, one
    forward-looking camera a drone, as nested lists of numpy arrays. The
    infrared views carry N(0, 0.01) pixel noise, as
    ``image_world.render_steps`` draws it, ``image_world.CHUNK`` views a
    render call; all draws come from one ``torch.Generator`` seeded with
    ``seed``."""
    # the rig's front camera with no baseline: the body pose, yaw wrapped
    cams = image_world.rig_poses(gt, frames, 0.0)[:, :, 0, 0]   # (S, D, 4)
    S, D = cams.shape[:2]
    poses = torch.tensor(cams.reshape(-1, 4), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    V = poses.shape[0]
    ir = torch.empty((V, h, w), dtype=torch.uint8, device=device)
    depth = torch.empty((V, h, w), dtype=torch.int32, device=device)
    for i in range(0, V, image_world.CHUNK):
        chunk = slice(i, i + image_world.CHUNK)
        img = world.render(poses[chunk], fx, fy, h, w)
        img = img + 0.01 * torch.randn(img.shape, generator=gen,
                                       dtype=torch.float64, device=device)
        ir[chunk] = (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        z = wall_depth(world, poses[chunk], fx, fy, h, w)
        depth[chunk] = sensor_depth(z, sensor, gen)
    ir = ir.reshape(S, D, h, w).cpu().numpy()
    depth = depth.reshape(S, D, h, w).cpu().numpy().astype(np.uint16)
    return [[(ir[k, d], depth[k, d]) for d in range(D)] for k in range(S)]
