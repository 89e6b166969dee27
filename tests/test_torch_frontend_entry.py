"""Port vs reference: the front-end slice as a whole.

``frontend_entry(device="cpu")`` at a small size (2 drones x 6 steps,
96 x 160 views) against the same composition of JAX calls: the demo's
renderer, ``OmniLoopCam.on_fisheye_frames_batch``, ``placedb.query_batch``
and ``placedb.add``. Tolerances:

- at least 98% of the reference's valid keypoints have a port keypoint
  within 0.3 px in the same keyframe, and the per-keyframe keypoint and
  landmark counts agree within 2%;
- landmarks on common keypoints within 1e-3 m + 2^-7 of their range: both
  packages round landmarks to f16 on the way out (one step is up to 2^-10
  of the value), and the midpoint solve of near-parallel stereo rays
  amplifies the f32 rounding of far points (observed: up to 4 f16 steps at
  18 m); the median difference must stay below 1e-3 m;
- the same top-1 indices, similarities within 1e-5, and the same top-1
  precision when the reference's hits are scored with the demo's own
  revisit gate (``demo_revisit_precision``, independent of the port);
- the per-keyframe checksums within ``frontend_entry.checksum_faults``'s
  tolerances, the ones ``chip_smoke.py`` holds the card's run to.

Run as a script, it prints the full-size anchors that ``chip_smoke.py``
holds the card's run against as ``FE_ANCHORS`` (5 drones x 30 steps,
400 x 208; several minutes of CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_frontend_entry.py --anchors
"""
import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch import frontend_entry as fe

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_drones=2, num_frames=6, height=96, width=160)


def _demo_module():
    spec = importlib.util.spec_from_file_location(
        "run_image_demo", ROOT / "examples" / "run_image_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_frontend(num_drones=5, num_frames=30, kf_every=2, seed=7,
                 height=208, width=400):
    """The reference's composition of the path: (sim data, keyframes,
    valid keypoints per keyframe, top-1 indices, top-1 similarities)."""
    from omniswarm_tpu import sim as jsim
    from omniswarm_tpu.config import FrontendParams
    from omniswarm_tpu.ops import placedb as jpdb
    from omniswarm_tpu.sim.image_world import RoomWorld
    from omniswarm_tpu.swarm.loop_cam import CameraIntrinsics, OmniLoopCam

    demo = _demo_module()
    data = jsim.generate(jsim.SimParams(
        num_drones=num_drones, num_frames=num_frames, seed=seed,
        radius_range=(2.0, 3.5), z_range=(0.8, 2.0)))
    fp = FrontendParams(height=height, width=width, match_index_dist=4,
                        netvlad_thres=0.35)
    intr = CameraIntrinsics(fx=220, fy=220, cx=fp.width / 2,
                            cy=fp.height / 2)
    world = RoomWorld(half=6.0, seed=11)
    rng = np.random.default_rng(0)
    cam = OmniLoopCam(params=fp, intrinsics=intr, baseline=demo.BASELINE)
    db = jpdb.make_placedb(fp.max_db_size, fp.global_desc_dim)
    kfs_all, kps, idxs, sims = [], [], [], []
    for k in range(0, num_frames, kf_every):
        t = float(data.times[k])
        entries = []
        for d in range(num_drones):
            pairs = [demo.render_direction_stereo(
                world, data.gt[k, d], vy, intr, fp.height, fp.width, rng)
                for vy in OmniLoopCam.VIEW_YAWS]
            entries.append((d, k, t, data.vio[k, d], pairs))
        kfs = cam.on_fisheye_frames_batch(entries)
        # keypoint validity is not part of KeyframeData: re-run the
        # extractor on the left views as the fused path feeds them
        lefts = np.stack([p[0] for e in entries for p in e[4]])
        imgs = jnp.asarray(lefts[..., None]).astype(jnp.float32) * (
            1.0 / 255.0)
        valid = np.asarray(cam._kp(imgs)[3])
        kps.extend(valid.reshape(num_drones, -1).sum(1))
        descs = jnp.asarray(np.stack([kf.global_desc for kf in kfs]))
        i, s = jpdb.query_batch(
            db, descs, jnp.asarray([kf.drone_id for kf in kfs]),
            jnp.asarray([kf.frame_id for kf in kfs]),
            match_index_dist=fp.match_index_dist)
        idxs.append(np.asarray(i))
        sims.append(np.asarray(s))
        for kf in kfs:
            db = jpdb.add(db, jnp.asarray(kf.global_desc),
                          jnp.asarray(kf.drone_id), jnp.asarray(kf.frame_id))
        kfs_all.extend(kfs)
    return (data, kfs_all, np.asarray(kps), np.concatenate(idxs),
            np.concatenate(sims))


def demo_revisit_precision(gt, kf_steps, guard, keyframes, top1_idx,
                           top1_sim, thres):
    """(precision, confident) of top-1 hits scored with the demo's revisit
    gate, built as run_image_demo.py:197-211 builds it: the set of keyframe
    pairs within 1.5 m in ground truth, same-drone pairs at least ``guard``
    frames apart."""
    D = gt.shape[1]
    opps = set()
    for i, ka in enumerate(kf_steps):
        for kb in kf_steps[: i + 1]:
            for da in range(D):
                for db in range(D):
                    if da == db and abs(ka - kb) < guard:
                        continue
                    if (da, ka) == (db, kb):
                        continue
                    if np.linalg.norm(gt[ka, da, :3] - gt[kb, db, :3]) < 1.5:
                        a, b = (da, ka), (db, kb)
                        opps.add((min(a, b), max(a, b)))
    pairs = [((kf.drone_id, kf.frame_id),
              (keyframes[j].drone_id, keyframes[j].frame_id))
             for kf, j, s in zip(keyframes, top1_idx, top1_sim) if s >= thres]
    true = sum((min(a, b), max(a, b)) in opps for a, b in pairs)
    return true / max(len(pairs), 1), len(pairs)


@pytest.fixture(scope="module")
def both():
    return jax_frontend(**SMALL), fe.frontend_entry(device="cpu", **SMALL)


def test_counts_and_keypoints_agree(both):
    (data, jkfs, jkp, _ji, _js), res = both
    assert len(res.keyframes) == len(jkfs) == 6
    jlm = np.asarray([int(kf.valid.sum()) for kf in jkfs])
    np.testing.assert_allclose(res.keypoints, jkp, rtol=0.02)
    np.testing.assert_allclose(res.landmarks, jlm, rtol=0.02)
    common = total = 0
    for a, b in zip(jkfs, res.keyframes):
        pa, pb = a.kp_xy[a.valid], b.kp_xy[b.valid]
        dist = np.linalg.norm(pa[:, None] - pb[None], axis=-1)
        common += int((dist.min(1) < 0.3).sum())
        total += len(pa)
    assert common >= 0.98 * total, (common, total)


def test_landmarks_on_common_keypoints(both):
    (_data, jkfs, *_), res = both
    diffs, tols = [], []
    for a, b in zip(jkfs, res.keyframes):
        both_ok = a.valid & b.valid
        same = np.abs(a.kp_xy - b.kp_xy).max(1) < 0.3
        sel = both_ok & same
        rng_m = np.linalg.norm(a.landmarks_3d[sel], axis=1)
        diffs.append(np.abs(a.landmarks_3d[sel]
                            - b.landmarks_3d[sel]).max(1))
        tols.append(1e-3 + rng_m * 2.0 ** -7)
    diffs, tols = np.concatenate(diffs), np.concatenate(tols)
    assert len(diffs) > 100
    assert (diffs <= tols).all(), float((diffs - tols).max())
    assert np.median(diffs) <= 1e-3


def test_retrieval_agrees(both):
    (data, jkfs, _jkp, ji, js), res = both
    np.testing.assert_array_equal(res.top1_idx, ji)
    finite = np.isfinite(js)
    assert finite.sum() >= 3
    assert np.array_equal(np.isfinite(res.top1_sim), finite)
    np.testing.assert_allclose(res.top1_sim[finite], js[finite], atol=1e-5)
    p, n = demo_revisit_precision(data.gt, [0, 2, 4], 4 * 2, jkfs, ji, js,
                                  0.35)
    assert (res.precision, res.confident) == (p, n)
    for a, b in zip(jkfs, res.keyframes):
        np.testing.assert_allclose(b.global_desc, a.global_desc, atol=1e-4)


def test_checksums_agree(both):
    (_data, jkfs, *_), res = both
    faults, stats = fe.checksum_faults(fe.keyframe_checksums(res.keyframes),
                                       fe.keyframe_checksums(jkfs),
                                       SMALL["width"], SMALL["height"])
    assert not faults, (faults, stats)


def test_cpu_run_calls_no_kernel(both):
    _ref, res = both
    assert res.k2_launches == 0 and res.k3_launches == 0
    assert len(res.step_ms) == 3 and res.views_per_s > 0


def test_stereo_and_depth_frames_match():
    """LoopCam's single-pair stereo path (float images) and its RGB-D
    path, on a rendered WallWorld view, against the reference's."""
    from omniswarm_torch.config import FrontendParams as TParams
    from omniswarm_torch.sim.image_world import WallWorld
    from omniswarm_torch.swarm.loop_cam import CameraIntrinsics, LoopCam
    from omniswarm_tpu.config import FrontendParams as JParams
    from omniswarm_tpu.swarm import loop_cam as jcam

    size = dict(height=96, width=160)
    intr = dict(fx=120.0, fy=120.0, cx=80.0, cy=48.0)
    left, right = WallWorld(seed=2).render_stereo(
        np.asarray([0.0, 0.3, 0.0, 0.1]), CameraIntrinsics(**intr), 96, 160,
        0.12, rng=np.random.default_rng(5))
    pose = np.asarray([1.0, 2.0, 0.5, 0.3])
    jc = jcam.LoopCam(params=JParams(**size),
                      intrinsics=jcam.CameraIntrinsics(**intr))
    tc = LoopCam(params=TParams(**size), intrinsics=CameraIntrinsics(**intr),
                 device="cpu")
    ja = jc.on_stereo_frame(1, 7, 3.5, pose, left, right)
    ta = tc.on_stereo_frame(1, 7, 3.5, pose, left, right)
    assert ja.valid.sum() > 20
    assert abs(int(ta.valid.sum()) - int(ja.valid.sum())) <= 2
    np.testing.assert_allclose(ta.global_desc, ja.global_desc, atol=1e-4)
    np.testing.assert_allclose(ta.kp_xy, ja.kp_xy, atol=0.3)
    depth = np.full((96, 160), 2.5, np.float32)
    jd = jc.on_depth_frame(1, 8, 4.0, pose, left, depth)
    td = tc.on_depth_frame(1, 8, 4.0, pose, left, depth)
    np.testing.assert_array_equal(td.valid, jd.valid)
    np.testing.assert_allclose(td.kp_xy, jd.kp_xy, atol=1e-3)
    np.testing.assert_allclose(td.landmarks_3d, jd.landmarks_3d, atol=1e-4)
    np.testing.assert_allclose(td.global_desc, jd.global_desc, atol=1e-4)
    np.testing.assert_allclose(td.local_desc[td.valid],
                               jd.local_desc[jd.valid], atol=1e-4)


def anchors() -> dict:
    """Full-size anchors of the path from the JAX package on the CPU."""
    data, kfs, _kps, idx, sims = jax_frontend()
    precision, confident = demo_revisit_precision(
        data.gt, list(range(0, 30, 2)), 4 * 2, kfs, idx, sims, 0.35)
    sums = fe.keyframe_checksums(kfs)
    return {"keyframes": len(kfs),
            "landmarks": sums["landmarks"],
            "kp_sum": [[round(v, 3) for v in row] for row in sums["kp_sum"]],
            "lm_inv_sum": [[round(v, 6) for v in row]
                           for row in sums["lm_inv_sum"]],
            "gd_proj": [round(v, 7) for v in sums["gd_proj"]],
            "top1_idx": [int(i) for i in idx],
            "top1_precision": precision, "confident_queries": confident}


if __name__ == "__main__":
    if "--anchors" not in sys.argv:
        sys.exit("usage: python tests/test_torch_frontend_entry.py --anchors")
    print(json.dumps(anchors()))
