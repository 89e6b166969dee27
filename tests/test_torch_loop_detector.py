"""The port's LoopDetector against the JAX reference, loop for loop.

The cases mirror ``tests/test_loop_detector_parity.py``: the local/remote
DB split, pose accuracy, per-mode thresholds, the top-k candidates (in the
fused tick and in the ``verify_batch=False`` walk), ``prevent_adding_db``,
the odometry gate and perceptual aliasing. Both detectors are fed the same
keyframes, and the port's random draws are replaced by JAX's Gumbel draws
for the keys the reference uses (``use_jax_draws``), so the accepted loops
must be equal edge for edge, with ``dpose`` within 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.config import FrontendParams as TFrontendParams
from omniswarm_torch.swarm.comm import KeyframeData as TKeyframeData
from omniswarm_torch.swarm.loop_detector import LoopDetector as TLoopDetector
from omniswarm_tpu.config import FrontendParams
from omniswarm_tpu.sim.simulator import delta_pose_np, wrap
from omniswarm_tpu.swarm.comm import KeyframeData
from omniswarm_tpu.swarm.loop_detector import LoopDetector

torch.set_num_threads(1)
GDIM = 64
K = 64
FX = 220.0
HOM_HYP = 256


# ---------------------------------------------------------------------------
# the reference's random draws, injected into the port
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("lanes", "hyp", "kb"))
def _tick_draw(seed, *, lanes, hyp, kb):
    """The reference tick's keys (``PRNGKey(seed)`` split into the lanes,
    each split into homography and PnP keys) and their Gumbel noise."""
    keys = jax.random.split(jax.random.PRNGKey(seed), lanes)
    pair = jax.vmap(jax.random.split)(keys)
    g = lambda k, h: jax.random.gumbel(k, (h, 4, kb), jnp.float32)
    return (jax.vmap(lambda k: g(k, HOM_HYP))(pair[:, 0]),
            jax.vmap(lambda k: g(k, hyp))(pair[:, 1]))


@functools.partial(jax.jit, static_argnames=("hyp", "kb"))
def _walk_draw(key, *, hyp, kb):
    key, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return (key, jax.random.gumbel(k1, (1, HOM_HYP, 4, kb), jnp.float32),
            jax.random.gumbel(k2, (1, hyp, 4, kb), jnp.float32))


def use_jax_draws(det: TLoopDetector, seed: int) -> TLoopDetector:
    """Replace the port detector's draws by the reference's for a detector
    made with ``seed``: the tick's ``PRNGKey(np.uint32(tick_seed))`` and the
    walk's key chain from ``PRNGKey(seed)``."""
    hyp = det.p.pnp_iterations
    use_hom = det.p.homography_prefilter

    def tick_noise(tick_seed, Qb, C, Kb):
        hom, pnp = _tick_draw(np.uint32(tick_seed), lanes=Qb * C, hyp=hyp,
                              kb=Kb)
        return (torch.from_numpy(np.array(hom)) if use_hom else None,
                torch.from_numpy(np.array(pnp)))

    state = {"key": jax.random.PRNGKey(seed)}

    def walk_noise(Kb):
        state["key"], hom, pnp = _walk_draw(state["key"], hyp=hyp, kb=Kb)
        return (torch.from_numpy(np.array(hom)) if use_hom else None,
                torch.from_numpy(np.array(pnp)))

    det.tick_noise = tick_noise
    det.walk_noise = walk_noise
    return det


def to_port_kf(kf: KeyframeData) -> TKeyframeData:
    return TKeyframeData(**kf.__dict__)


def to_port_params(p: FrontendParams) -> TFrontendParams:
    return TFrontendParams(**p.__dict__)


def detector_pair(self_id, p=None, seed=0, global_dim=GDIM):
    p = p or FrontendParams()
    ref = LoopDetector(self_id, p, global_dim=global_dim, seed=seed)
    port = use_jax_draws(TLoopDetector(self_id, to_port_params(p),
                                       global_dim=global_dim, seed=seed,
                                       device="cpu"), seed)
    return ref, port


def assert_same_loops(got, want):
    """Lists of LoopCandidate (or None) equal edge for edge."""
    got = [] if got is None else (got if isinstance(got, list) else [got])
    want = [] if want is None else (want if isinstance(want, list)
                                    else [want])
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        ge, we = g.edge, w.edge
        assert (ge.drone_a, ge.t_a, ge.drone_b, ge.t_b) == \
            (we.drone_a, we.t_a, we.drone_b, we.t_b)
        assert g.num_inliers == w.num_inliers
        # a 4096-wide f32 dot product, summed in another order
        assert g.similarity == pytest.approx(w.similarity, abs=1e-5)
        np.testing.assert_allclose(ge.dpose, we.dpose, atol=1e-4)


def both(ref, port, kf, **kw):
    """Feed one keyframe to both detectors; the loops must agree. Returns
    the reference's result."""
    want = ref.on_keyframe(kf, **kw)
    got = port.on_keyframe(to_port_kf(kf), **kw)
    assert_same_loops(got, want)
    assert len(port.local_kfs) == len(ref.local_kfs)
    assert len(port.remote_kfs) == len(ref.remote_kfs)
    assert port.local_db.cursor == int(ref.local_db.cursor)
    return want


# ---------------------------------------------------------------------------
# the scene of tests/test_loop_detector_parity.py
# ---------------------------------------------------------------------------

def unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def make_world_points(rng, n=K):
    y = rng.uniform(-2.0, 2.0, n)
    z = rng.uniform(-1.0, 1.0, n)
    x = 3.0 + 0.12 * rng.normal(size=n)
    return np.stack([x, y, z], 1).astype(np.float32)


def body_frame(points_w, pose):
    c, s = np.cos(pose[3]), np.sin(pose[3])
    d = points_w - pose[:3]
    return np.stack([c * d[:, 0] + s * d[:, 1],
                     -s * d[:, 0] + c * d[:, 1],
                     d[:, 2]], 1).astype(np.float32)


def project(p3):
    x = np.maximum(p3[:, 0], 0.1)
    u = 200.0 - FX * p3[:, 1] / x
    v = 104.0 - FX * p3[:, 2] / x
    return np.stack([u, v], 1).astype(np.float32)


def make_kf(drone, frame, t, pose, points_w, gdesc, ldesc):
    p3 = body_frame(points_w, np.asarray(pose, float))
    return KeyframeData(
        drone_id=drone, frame_id=frame, t=t,
        pose=np.asarray(pose, np.float32),
        global_desc=unit(gdesc), kp_xy=project(p3),
        landmarks_3d=p3, local_desc=ldesc,
        valid=np.ones(K, bool))


@pytest.fixture
def scene(rng):
    points = make_world_points(rng)
    ldesc = rng.normal(size=(K, 32)).astype(np.float32)
    ldesc /= np.linalg.norm(ldesc, axis=1, keepdims=True)
    g1 = rng.normal(size=GDIM)
    return points, ldesc, g1


@pytest.mark.parametrize("verify_batch", [True, False])
def test_local_remote_db_split(scene, verify_batch):
    points, ldesc, g = scene
    ref, port = detector_pair(0, FrontendParams(verify_batch=verify_batch))
    assert both(ref, port, make_kf(2, 0, 0.0, [0, 0, 0, 0], points, g,
                                   ldesc)) is None
    assert both(ref, port, make_kf(2, 50, 5.0, [0.3, -0.2, 0.1, 0.04],
                                   points, g, ldesc)) is None
    assert len(port.remote_kfs) == 2 and len(port.local_kfs) == 0
    res = both(ref, port, make_kf(0, 3, 6.0, [0.1, 0.4, -0.1, -0.03],
                                  points, g, ldesc))
    assert res is not None and {res.edge.drone_a, res.edge.drone_b} == {0, 2}


@pytest.mark.parametrize("verify_batch", [True, False])
def test_loop_edge_pose_accuracy(scene, verify_batch):
    points, ldesc, g = scene
    ref, port = detector_pair(0, FrontendParams(verify_batch=verify_batch))
    pose_a = np.array([0.0, 0.0, 0.0, 0.0])
    pose_b = np.array([0.4, -0.3, 0.15, 0.06])
    both(ref, port, make_kf(0, 0, 0.0, pose_a, points, g, ldesc))
    res = both(ref, port, make_kf(0, 50, 5.0, pose_b, points, g, ldesc))
    assert res is not None
    err = res.edge.dpose - delta_pose_np(pose_b, pose_a)
    assert np.linalg.norm(err[:3]) < 0.05 and abs(wrap(err[3])) < 0.02


def test_per_mode_thresholds(scene, rng):
    points, ldesc, g1 = scene
    p = FrontendParams(netvlad_thres=0.5, netvlad_init_thres=0.2,
                       inter_drone_init_frames=1)
    g_weak = unit(unit(g1) * 0.35 + np.sqrt(1 - 0.35 ** 2) * unit(
        rng.normal(size=GDIM) - unit(g1) * (unit(rng.normal(size=GDIM))
                                            @ unit(g1))))
    ref, port = detector_pair(0, p)
    both(ref, port, make_kf(0, 0, 0.0, [0, 0, 0, 0], points, g1, ldesc))
    res = both(ref, port, make_kf(2, 10, 1.0, [0.2, 0.1, 0.0, 0.02], points,
                                  g_weak, ldesc))
    assert res is not None
    assert p.netvlad_init_thres <= res.similarity < p.netvlad_thres
    assert both(ref, port, make_kf(2, 90, 9.0, [0.25, 0.05, 0.0, 0.0],
                                   points, g_weak, ldesc)) is None
    assert port.pair_loop_count == ref.pair_loop_count


@pytest.mark.parametrize("verify_batch", [True, False])
def test_topk_candidate_evaluation(scene, rng, verify_batch):
    points, ldesc, g1 = scene
    ref, port = detector_pair(0, FrontendParams(search_nearest_num=5,
                                                verify_batch=verify_batch))
    decoy_ldesc = rng.normal(size=(K, 32)).astype(np.float32)
    decoy_ldesc /= np.linalg.norm(decoy_ldesc, axis=1, keepdims=True)
    decoy_pts = make_world_points(rng) + np.array([0, 30.0, 0])
    both(ref, port, make_kf(2, 0, 0.0, [0, 25, 0, 0], decoy_pts, g1,
                            decoy_ldesc))
    g_real = unit(np.asarray(g1) + 0.1 * rng.normal(size=GDIM))
    both(ref, port, make_kf(3, 0, 0.0, [0, 0, 0, 0], points, g_real, ldesc))
    res = both(ref, port, make_kf(0, 5, 1.0, [0.3, -0.1, 0.1, 0.03], points,
                                  g1, ldesc))
    assert res is not None and {res.edge.drone_a, res.edge.drone_b} == {0, 3}


def test_prevent_adding_db(scene):
    points, ldesc, g = scene
    ref, port = detector_pair(0)
    both(ref, port, make_kf(2, 0, 0.0, [0, 0, 0, 0], points, g, ldesc))
    res = both(ref, port, make_kf(0, 1, 1.0, [0.2, 0.2, 0.0, 0.0], points,
                                  g, ldesc), prevent_adding_db=True)
    assert res is not None
    assert len(port.local_kfs) == 0 and port.local_db.cursor == 0


@pytest.mark.parametrize("threshold,lie", [(2.0, True), (2.0, False),
                                           (1e9, True)])
def test_odometry_consistency_gate(scene, threshold, lie):
    points, ldesc, g = scene
    pose_a = np.array([0.0, 0.0, 0.0, 0.0])
    pose_b = np.array([0.4, -0.3, 0.15, 0.06])
    ref, port = detector_pair(0, FrontendParams(
        odometry_consistency_threshold=threshold))
    both(ref, port, make_kf(0, 0, 0.0, pose_a, points, g, ldesc))
    kfb = make_kf(0, 50, 5.0, pose_b, points, g, ldesc)
    if lie:
        kfb.pose = np.array([2.0, 1.5, 0.0, 0.0], np.float32)
    res = both(ref, port, kfb)
    assert (res is None) == (lie and threshold < 1e3)


def test_batch_of_remote_keyframes(scene, rng):
    """A node's comm tick: several keyframes in one batch (Qb = 4), the
    queries seeing the databases as before the batch."""
    points, ldesc, g = scene
    ref, port = detector_pair(1, FrontendParams(search_nearest_num=3))
    both(ref, port, make_kf(1, 0, 0.0, [0, 0, 0, 0], points, g, ldesc))
    kfs = [make_kf(d, 10 + d, 1.0 + d, [0.1 * d, -0.2, 0.05, 0.02 * d],
                   points, unit(np.asarray(g) + 0.05 * rng.normal(
                       size=GDIM)), ldesc) for d in (0, 2, 3)]
    want = ref.on_keyframes_batch(kfs, [False, False, True])
    got = port.on_keyframes_batch([to_port_kf(k) for k in kfs],
                                  [False, False, True])
    assert len(got) == len(want) == 3
    for g_, w_ in zip(got, want):
        assert_same_loops(g_, w_)
    assert sum(len(w) for w in want) >= 2
    assert port.remote_db.cursor == int(ref.remote_db.cursor) == 2


def test_aliasing_precision(rng):
    """Tiled wall texture: aliased cross-segment matches rejected, the true
    revisits closed, by both detectors alike (keyframes from the reference's
    LoopCam)."""
    from omniswarm_tpu.sim.image_world import WallWorld
    from omniswarm_tpu.swarm.loop_cam import CameraIntrinsics, LoopCam

    p = FrontendParams()
    world = WallWorld(seed=7)
    patch = world.texture[:128, :128]
    world.texture = np.tile(patch, (world.tex_h // 128,
                                    world.tex_w // 128)).astype(np.float32)
    intr = CameraIntrinsics(fx=220, fy=220, cx=p.width / 2, cy=p.height / 2)
    cam = LoopCam(params=p, intrinsics=intr, baseline=0.2)
    ref, port = detector_pair(0, p, global_dim=p.global_desc_dim)
    period = 128 * world.m_per_px
    poses = [np.array([0.0, y, 0.5 + 0.01 * rep, 0.0])
             for rep in range(2) for y in np.linspace(-period, period, 5)]
    n_true = n_false = 0
    for i, pose in enumerate(poses):
        L, R = world.render_stereo(pose, intr, p.height, p.width, 0.2,
                                   rng=rng)
        res = both(ref, port, cam.on_stereo_frame(0, i * 20, float(i), pose,
                                                  L, R))
        if res is not None:
            gt = delta_pose_np(pose, poses[int(round(res.edge.t_b))])
            if np.linalg.norm(res.edge.dpose[:3] - gt[:3]) < 0.5:
                n_true += 1
            else:
                n_false += 1
    assert n_false == 0 and n_true >= 2, (n_true, n_false)


def test_match_viz_dir_needs_slice_6():
    with pytest.raises(NotImplementedError, match="slice 6"):
        TLoopDetector(0, device="cpu", match_viz_dir="viz")
