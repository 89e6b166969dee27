"""Frame-dense factor graph, its gold assembly and the block-tridiagonal LM.

Counterpart of ``omniswarm_tpu/solver/dense.py``:

- the graph container, its host-side construction from a simulation
  (``dense_graph_from_sim``) and from a generic graph
  (``dense_from_factor_graph``, None when the structure does not fit);
- the dense gold path: residual/Jacobian grids, ``assemble_dense`` (the full
  (P, P) Hessian) and ``lm_solve_dense`` / ``lm_solve_dense_batched``;
- the frame-block normal equations (``assemble_blocks``: dense loop columns
  U, or the sparse ``SparseLoops`` form) and the three linear solves of
  ``lm_solve_bt``: Woodbury on the Newton-Schulz cyclic reduction (the fast
  path, with K1 on packed warm levels), Woodbury on the exact Cholesky
  ``bt_solve`` (``exact_linear=True``) and BT-preconditioned CG with the
  loops applied sparsely (``linear="pcg"``, which also launches K1);
- ``lm_solve_bt_batched``, lanes in lock-step, and ``pose_covariances``.

Scatter-adds are ``index_put_(accumulate=True)`` (sort-based on CUDA, so a
sum over a shared row has the same order in every run) or products; no
``index_add_``, whose CUDA form is a float atomic.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from omniswarm_torch.core import geometry as geo
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver import factors as fx
from omniswarm_torch.solver.block_tridiag import (
    bt_apply, bt_factor, bt_matvec, bt_solve, bt_warm_state,
    cholesky_solve_checked, pack_bt_cols, pack_bt_mats, spd_ns_inverse,
    unpack_bt_cols)
from omniswarm_torch.solver.gauss_newton import (
    SolveResult, _apply_step, _jtj_pairs, _jtr, _param_mask,
    damped_cholesky_step, poses_to_device, reduce_equations, run_lm_loop)
from omniswarm_torch.solver.graph import RelPoseFactors, empty_relpose


class DenseGraph(NamedTuple):
    # UWB ranges: (F, D, D) upper-triangle-valid grid
    range_dist: torch.Tensor       # (F, D, D)
    range_valid: torch.Tensor      # (F, D, D) bool (use a<b half)
    range_sqrt_inf: torch.Tensor   # () or (F, D, D)
    # Ego-motion chain between consecutive frames
    odom_dpose: torch.Tensor       # (F-1, D, 4)
    odom_sqrt_info: torch.Tensor   # (F-1, D, 4) diagonal sqrt information
    odom_valid: torch.Tensor       # (F-1, D) bool
    # Same-frame drone detections a→b (bearing + inverse depth)
    det_dir: torch.Tensor          # (F, D, D, 3) unit bearing in a's frame
    det_tb: torch.Tensor           # (F, D, D, 2, 3) tangent basis
    det_invdep: torch.Tensor       # (F, D, D)
    det_valid: torch.Tensor        # (F, D, D) bool
    det_has_depth: torch.Tensor    # (F, D, D) bool
    # Sparse loop closures
    loops: RelPoseFactors
    # Pose masks
    pose_valid: torch.Tensor       # (F, D)
    pose_fixed: torch.Tensor       # (F, D)
    yaw_fixed: torch.Tensor        # (F, D)
    # Optional per-drone UWB antenna offsets (D, 3), body frame; None == 0
    ant_pos: torch.Tensor = None


def empty_dense_graph(F: int, D: int, max_loops: int = 256,
                      dtype=torch.float32, device="cuda") -> DenseGraph:
    dev = resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    b = torch.bool
    return DenseGraph(
        range_dist=z(F, D, D), range_valid=z(F, D, D, dt=b),
        range_sqrt_inf=torch.tensor(1.0, dtype=dtype, device=dev),
        odom_dpose=z(max(F - 1, 1), D, 4),
        odom_sqrt_info=z(max(F - 1, 1), D, 4),
        odom_valid=z(max(F - 1, 1), D, dt=b),
        det_dir=z(F, D, D, 3), det_tb=z(F, D, D, 2, 3), det_invdep=z(F, D, D),
        det_valid=z(F, D, D, dt=b), det_has_depth=z(F, D, D, dt=b),
        loops=empty_relpose(max_loops, dtype, dev),
        pose_valid=z(F, D, dt=b), pose_fixed=z(F, D, dt=b),
        yaw_fixed=z(F, D, dt=b),
    )


def dense_graph_from_sim(sim_data, *, distance_cov: float = 0.02,
                         vo_cov_pos_per_meter: float = 0.002,
                         vo_cov_yaw_per_meter: float = 0.0001,
                         self_id: int = 0,
                         enable_detections: bool = True,
                         loops_override=None,
                         max_loops: Optional[int] = None,
                         ant_pos=None) -> DenseGraph:
    """Build a DenseGraph from sim.SimData on the host.

    The leaves are numpy arrays, exactly as the reference builds them;
    ``lm_solve_bt`` (or ``convert.dense_graph_to_torch``) moves them to the
    device in one pass.
    """
    from omniswarm_torch.sim.simulator import delta_pose_np

    F, D = sim_data.gt.shape[:2]
    loops_src = loops_override if loops_override is not None \
        else sim_data.loops
    L = max_loops or max(8, len(loops_src))

    # ranges (a < b half)
    tri = np.triu(np.ones((D, D), bool), 1)
    range_valid = np.asarray(sim_data.range_valid) & tri[None]

    # odometry from VIO deltas (vectorized over the frame axis)
    vio = np.asarray(sim_data.vio)
    d = delta_pose_np(vio[:-1], vio[1:]).astype(np.float32)  # (F-1, D, 4)
    seg = np.maximum(np.linalg.norm(d[..., :3], axis=-1), 1e-3)
    si = np.empty((F - 1, D, 4), np.float32)
    si[..., :3] = (1.0 / np.sqrt(vo_cov_pos_per_meter * seg))[..., None]
    si[..., 3] = 1.0 / np.sqrt(vo_cov_yaw_per_meter * seg)

    # detections (same frame, a sees b)
    det_dir = np.zeros((F, D, D, 3), np.float32)
    det_tb = np.zeros((F, D, D, 2, 3), np.float32)
    det_invdep = np.zeros((F, D, D), np.float32)
    det_valid = np.zeros((F, D, D), bool)
    if enable_detections and sim_data.detections:
        dets = sim_data.detections
        fab = np.asarray([(dd.frame, dd.drone_a, dd.drone_b) for dd in dets])
        dirs = np.asarray([dd.direction for dd in dets], np.float32)
        tbs = geo.tangent_base_from_unit_np(dirs)
        det_dir[fab[:, 0], fab[:, 1], fab[:, 2]] = dirs
        det_tb[fab[:, 0], fab[:, 1], fab[:, 2]] = tbs
        det_invdep[fab[:, 0], fab[:, 1], fab[:, 2]] = [
            dd.inv_dep for dd in dets]
        det_valid[fab[:, 0], fab[:, 1], fab[:, 2]] = True

    # loops (numpy struct-of-arrays)
    lfa = np.zeros(L, np.int32)
    lda = np.zeros(L, np.int32)
    lfb = np.zeros(L, np.int32)
    ldb = np.zeros(L, np.int32)
    ldp = np.zeros((L, 4), np.float32)
    lsi = np.zeros((L, 4, 4), np.float32)
    lv = np.zeros(L, bool)
    for i, lp in enumerate(loops_src):
        lfa[i], lda[i], lfb[i], ldb[i] = (lp.frame_a, lp.drone_a,
                                          lp.frame_b, lp.drone_b)
        ldp[i] = lp.dpose
        lsi[i] = np.diag([1.0 / lp.pos_std] * 3 + [1.0 / lp.yaw_std])
        lv[i] = True

    pose_valid = np.ones((F, D), bool)
    pose_fixed = np.zeros((F, D), bool)
    pose_fixed[0, self_id] = True

    return DenseGraph(
        range_dist=np.asarray(sim_data.ranges, np.float32),
        range_valid=range_valid,
        range_sqrt_inf=np.float32(1.0 / np.sqrt(distance_cov)),
        odom_dpose=d, odom_sqrt_info=si,
        odom_valid=np.ones((F - 1, D), bool),
        det_dir=det_dir, det_tb=det_tb, det_invdep=det_invdep,
        det_valid=det_valid, det_has_depth=det_valid,
        loops=RelPoseFactors(lfa, lda, lfb, ldb, ldp, lsi, lv),
        pose_valid=pose_valid, pose_fixed=pose_fixed,
        yaw_fixed=np.zeros((F, D), bool),
        ant_pos=None if ant_pos is None
        else np.asarray(ant_pos, np.float32),
    )


def _np(x):
    """A leaf as a numpy array (numpy, JAX or torch on any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dense_from_factor_graph(fg) -> Optional[DenseGraph]:
    """A generic FactorGraph as a DenseGraph (numpy leaves), or None.

    Requirements: ego-motion factors connect consecutive frames of one
    drone with a diagonal sqrt information; detections are same-frame with
    zero dpose corrections. Any factor that breaks the frame structure
    returns None (the caller keeps the generic scatter path).
    """
    F, D = _np(fg.pose_valid).shape

    o = fg.odoms
    rows = np.flatnonzero(_np(o.valid))
    fa, fb = _np(o.frame_a)[rows], _np(o.frame_b)[rows]
    da, db = _np(o.drone_a)[rows], _np(o.drone_b)[rows]
    if rows.size and (np.any(da != db) or np.any(fb != fa + 1)):
        return None
    si_full = _np(o.sqrt_info)[rows]
    if rows.size and np.abs(
            si_full - np.einsum("kij,ij->kij", si_full, np.eye(4))).max() \
            > 1e-6:
        return None
    odom_dpose = np.zeros((max(F - 1, 1), D, 4), np.float32)
    odom_si = np.zeros((max(F - 1, 1), D, 4), np.float32)
    odom_valid = np.zeros((max(F - 1, 1), D), bool)
    odom_dpose[fa, da] = _np(o.dpose)[rows]
    odom_si[fa, da] = np.einsum("kii->ki", si_full)
    odom_valid[fa, da] = True

    r = fg.ranges
    rrows = np.flatnonzero(_np(r.valid))
    range_dist = np.zeros((F, D, D), np.float32)
    range_si = np.zeros((F, D, D), np.float32)
    range_valid = np.zeros((F, D, D), bool)
    rf = _np(r.frame)[rrows]
    ra, rb = _np(r.drone_a)[rrows], _np(r.drone_b)[rrows]
    lo, hi = np.minimum(ra, rb), np.maximum(ra, rb)
    range_dist[rf, lo, hi] = _np(r.dist)[rrows]
    range_si[rf, lo, hi] = _np(r.sqrt_inf)[rrows]
    range_valid[rf, lo, hi] = True

    d = fg.dets
    drows = np.flatnonzero(_np(d.valid))
    dfa, dfb = _np(d.frame_a)[drows], _np(d.frame_b)[drows]
    if drows.size and np.any(dfa != dfb):
        return None
    if drows.size and (np.abs(_np(d.dpose_a)[drows]).max() > 1e-9
                       or np.abs(_np(d.dpose_b)[drows]).max() > 1e-9):
        return None
    dda, ddb = _np(d.drone_a)[drows], _np(d.drone_b)[drows]
    det_dir = np.zeros((F, D, D, 3), np.float32)
    det_tb = np.zeros((F, D, D, 2, 3), np.float32)
    det_invdep = np.zeros((F, D, D), np.float32)
    det_valid = np.zeros((F, D, D), bool)
    det_depth = np.zeros((F, D, D), bool)
    det_dir[dfa, dda, ddb] = _np(d.direction)[drows]
    det_tb[dfa, dda, ddb] = _np(d.tangent_base)[drows]
    det_invdep[dfa, dda, ddb] = _np(d.inv_dep)[drows]
    det_valid[dfa, dda, ddb] = True
    det_depth[dfa, dda, ddb] = _np(d.enable_depth)[drows]

    return DenseGraph(
        range_dist=range_dist, range_valid=range_valid,
        range_sqrt_inf=range_si, odom_dpose=odom_dpose,
        odom_sqrt_info=odom_si, odom_valid=odom_valid,
        det_dir=det_dir, det_tb=det_tb, det_invdep=det_invdep,
        det_valid=det_valid, det_has_depth=det_depth,
        loops=fg.loops, pose_valid=fg.pose_valid, pose_fixed=fg.pose_fixed,
        yaw_fixed=fg.yaw_fixed, ant_pos=fg.ant_pos,
    )


# ---------------------------------------------------------------------------
# The dense gold path: residual/Jacobian grids and the full Hessian
# ---------------------------------------------------------------------------

def _huber_w(norm, valid, delta):
    w = torch.where(norm <= delta, 1.0, delta / torch.clamp_min(norm, 1e-12))
    return w * valid.to(norm.dtype)


def _range_terms(graph: DenseGraph, poses, huber_delta):
    """Range residual grid r[f,a,b] = (||t_a - t_b|| - d) si with the
    Jacobian row si u of pose a (pose b takes -si u); returns (r, si u,
    w, cost), w the Huber weight times validity (applied squared)."""
    t = poses[..., :3]
    diff = t[:, :, None, :] - t[:, None, :, :]          # (F, D, D, 3)
    dist = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
    si = graph.range_sqrt_inf
    r = (dist - graph.range_dist) * si
    u = diff / dist[..., None]
    w = _huber_w(torch.abs(r), graph.range_valid, huber_delta)
    cost = 0.5 * torch.sum(torch.where(
        graph.range_valid, fx.huber_rho(r * r, huber_delta), 0.0))
    return r, u * si[..., None], w, cost


def _range_terms_ant(graph: DenseGraph, poses, huber_delta):
    """Range grids between antenna points t + R(yaw) ant: (r, Ja, Jb, w,
    cost) with full 4-wide Jacobian rows (ranges couple into yaw)."""
    ya = poses[..., 3]                                   # (F, D)
    ant = graph.ant_pos.to(poses.dtype)                  # (D, 3)
    teff = poses[..., :3] + geo.yaw_rotate(ya, ant[None])
    diff = teff[:, :, None, :] - teff[:, None, :, :]     # (F, Da, Db, 3)
    dist = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
    si = graph.range_sqrt_inf
    r = (dist - graph.range_dist) * si
    u = diff / dist[..., None]
    # d(R(ya) ant_a)/dya = [-s*ax - c*ay, c*ax - s*ay, 0]
    c, s = torch.cos(ya), torch.sin(ya)
    dR = torch.stack([-s * ant[None, :, 0] - c * ant[None, :, 1],
                      c * ant[None, :, 0] - s * ant[None, :, 1],
                      torch.zeros_like(ya)], -1)         # (F, D, 3)
    ka = torch.sum(u * dR[:, :, None, :], -1)            # (F, Da, Db)
    kb = torch.sum(u * dR[:, None, :, :], -1)
    si_b = si[..., None] if si.ndim else si
    ja4 = torch.cat([u, ka[..., None]], -1) * si_b
    jb4 = -torch.cat([u, kb[..., None]], -1) * si_b
    w = _huber_w(torch.abs(r), graph.range_valid, huber_delta)
    cost = 0.5 * torch.sum(torch.where(
        graph.range_valid, fx.huber_rho(r * r, huber_delta), 0.0))
    return r, ja4, jb4, w, cost


def _odom_stack(rows):
    """(..., 4, 4) from 4 rows of 4 (...)-shaped entries."""
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def _odom_terms(graph: DenseGraph, poses):
    """Ego-motion residual chain e = meas - delta(a, b) (yaw wrapped),
    r = s e, with Ja = diag(s) [[R(-ya), (-dy, dx, 0)^T], [0, 1]] and
    Jb = diag(s) [[-R(-ya), 0], [0, -1]]."""
    pa, pb = poses[:-1], poses[1:]                       # (F-1, D, 4)
    delta = geo.delta_pose(pa, pb)
    e = graph.odom_dpose - delta
    e = torch.cat([e[..., :3], geo.normalize_angle(e[..., 3:])], -1)
    s = graph.odom_sqrt_info
    r = s * e
    valid = graph.odom_valid
    cost = 0.5 * torch.sum(torch.where(valid, torch.sum(r * r, -1), 0.0))
    c, sn = torch.cos(pa[..., 3]), torch.sin(pa[..., 3])
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    dx_, dy_ = delta[..., 0], delta[..., 1]
    Ja = _odom_stack([[c, sn, zero, -dy_], [-sn, c, zero, dx_],
                      [zero, zero, one, zero], [zero, zero, zero, one]]
                     ) * s[..., :, None]                # (F-1, D, 4, 4)
    Jb = _odom_stack([[-c, -sn, zero, zero], [sn, -c, zero, zero],
                      [zero, zero, -one, zero], [zero, zero, zero, -one]]
                     ) * s[..., :, None]
    return r, Ja, Jb, valid.to(poses.dtype), cost


def _det_terms(graph: DenseGraph, poses, huber_delta, sphere_std,
               inv_dep_std):
    """Detection residual grid and Jacobians by the closed-form chain rule:
    rel = R(-ya)(tb - ta), unit = rel/n, res01 = TB (unit - dir)/σs,
    res2 = (invd - 1/n)/σi (masked by det_has_depth)."""
    dtype = poses.dtype
    t = poses[..., :3]
    ya = poses[..., 3]                                   # (F, D)
    diff = t[:, None, :, :] - t[:, :, None, :]           # (F, Da, Db, 3) b-a
    c = torch.cos(ya)[:, :, None]
    s = torch.sin(ya)[:, :, None]
    relx = c * diff[..., 0] + s * diff[..., 1]
    rely = -s * diff[..., 0] + c * diff[..., 1]
    relz = diff[..., 2]
    rel = torch.stack([relx, rely, relz], -1)            # (F, D, D, 3)
    n = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
    unit = rel / n[..., None]
    err3 = unit - graph.det_dir
    has = graph.det_has_depth.to(dtype)
    res01 = torch.einsum("fabkj,fabj->fabk", graph.det_tb, err3) / sphere_std
    res2 = (graph.det_invdep - 1.0 / n) / inv_dep_std * has
    r = torch.cat([res01, res2[..., None]], -1)          # (F, D, D, 3)

    # d rel/d tb = R(-ya), d rel/d ta = -R(-ya),
    # d rel/d ya = (rel_y, -rel_x, 0)
    z, o = torch.zeros_like(relx), torch.ones_like(relx)
    Rm = torch.stack([torch.stack([c + z, s + z, z], -1),
                      torch.stack([-s + z, c + z, z], -1),
                      torch.stack([z, z, o], -1)], -2)   # (F, D, D, 3, 3)
    drel_dya = torch.stack([rely, -relx, z], -1)
    eye3 = torch.eye(3, dtype=dtype, device=poses.device)
    P = (eye3 - unit[..., :, None] * unit[..., None, :]) / n[..., None, None]
    dres01 = torch.einsum("fabkj,fabji->fabki", graph.det_tb, P) / sphere_std
    dres2 = unit / (n * n)[..., None] / inv_dep_std * has[..., None]
    dres = torch.cat([dres01, dres2[..., None, :]], -2)  # (F, D, D, 3, 3)
    J_t_b = torch.einsum("fabki,fabij->fabkj", dres, Rm)
    J_yaw_a = torch.einsum("fabki,fabi->fabk", dres, drel_dya)
    Ja = torch.cat([-J_t_b, J_yaw_a[..., None]], -1)     # (F, D, D, 3, 4)
    Jb = torch.cat([J_t_b, torch.zeros_like(J_yaw_a)[..., None]], -1)

    norm = torch.linalg.vector_norm(r, dim=-1)
    w = _huber_w(norm, graph.det_valid, huber_delta)
    cost = 0.5 * torch.sum(torch.where(
        graph.det_valid, fx.huber_rho(norm * norm, huber_delta), 0.0))
    return r, Ja, Jb, w, cost


@highp()
def assemble_dense(graph: DenseGraph, poses: torch.Tensor, *,
                   huber_delta: float = 1.0, det_sphere_std: float = 0.1,
                   det_inv_dep_std: float = 0.5, axis=None, bad=None):
    """The full masked normal equations (H (P, P), g (P,), cost), P = 4FD.

    Same-frame (range, detection) blocks and the odometry chain come from
    the analytic grids and are written into H by index (each block once,
    no scatter); the loops, through the autodiff ``relpose_eval``, are one
    sort-based scatter-add. With ``axis`` the graph's validity masks hold
    this rank's factors, and H, g and the cost are summed over the ranks
    before the masks (``gauss_newton.reduce_equations``, flag ``bad``).
    """
    F, D = graph.pose_valid.shape
    dtype, dev = poses.dtype, poses.device
    N = F * D
    P = 4 * N
    intra = poses.new_zeros((F, D, D, 4, 4))
    diag = poses.new_zeros((F, D, 4, 4))                  # per-pose diagonal
    gvec = poses.new_zeros((F, D, 4))

    if graph.ant_pos is None:
        # Jacobian si u on pose a, -si u on pose b: both orientations of
        # the a<b grid share u u^T
        r_r, su, w_r, cost = _range_terms(graph, poses, huber_delta)
        wB3 = su[..., :, None] * su[..., None, :] * w_r[..., None, None]
        wB3_sym = wB3 + wB3.transpose(1, 2)
        diag[..., :3, :3] += torch.sum(wB3_sym, 2)
        intra[..., :3, :3] -= wB3_sym
        gr = su * (w_r * r_r)[..., None]
        gvec[..., :3] += torch.sum(gr - gr.transpose(1, 2), 2)
    else:
        r_r, ja4, jb4, w_r, cost = _range_terms_ant(graph, poses,
                                                    huber_delta)
        wja4 = ja4 * w_r[..., None]
        wjb4 = jb4 * w_r[..., None]
        diag += torch.sum(wja4[..., :, None] * ja4[..., None, :], 2)
        diag += torch.sum(wjb4[..., :, None] * jb4[..., None, :], 1)
        Bab_r = wja4[..., :, None] * jb4[..., None, :]
        intra += Bab_r + Bab_r.mT.transpose(1, 2)
        gvec += torch.sum(wja4 * r_r[..., None], 2)
        gvec += torch.sum(wjb4 * r_r[..., None], 1)

    if graph.det_dir is not None:
        r_d, Ja_d, Jb_d, w_d, cost_d = _det_terms(
            graph, poses, huber_delta, det_sphere_std, det_inv_dep_std)
        cost = cost + cost_d
        wJa = Ja_d * w_d[..., None, None]
        wJb = Jb_d * w_d[..., None, None]
        diag += torch.sum(_jtj_pairs(wJa, Ja_d), 2)
        diag += torch.sum(_jtj_pairs(wJb, Jb_d), 1)
        Bab = _jtj_pairs(wJa, Jb_d)
        intra += Bab + Bab.mT.transpose(1, 2)
        gvec += torch.sum(_jtr(wJa, r_d), 2)
        gvec += torch.sum(_jtr(wJb, r_d), 1)

    # odometry chain: diagonal at f and f+1, off-diagonal (f, f+1)
    r_o, Ja_o, Jb_o, w_o, cost_o = _odom_terms(graph, poses)
    cost = cost + cost_o
    wJa_o = Ja_o * w_o[..., None, None]
    wJb_o = Jb_o * w_o[..., None, None]
    diag[:-1] += _jtj_pairs(wJa_o, Ja_o)
    diag[1:] += _jtj_pairs(wJb_o, Jb_o)
    Bab_o = _jtj_pairs(wJa_o, Jb_o)                      # (F-1, D, 4, 4)
    gvec[:-1] += _jtr(wJa_o, r_o)
    gvec[1:] += _jtr(wJb_o, r_o)

    # H as (f, a, i, g, b, j): same-frame blocks, then the chain's blocks
    intra.diagonal(dim1=1, dim2=2).add_(diag.permute(0, 2, 3, 1))
    H6 = poses.new_zeros((F, D, 4, F, D, 4))
    fi = torch.arange(F, device=dev)
    H6[fi, :, :, fi] = intra.permute(0, 1, 3, 2, 4)
    fo = fi[:-1, None]
    do = torch.arange(D, device=dev)[None, :]
    H6[fo, do, :, fo + 1, do] = Bab_o
    H6[fo + 1, do, :, fo, do] = Bab_o.mT
    H = H6.reshape(P, P)

    # sparse loops: one scatter-add of their four 4x4 blocks each
    lp = graph.loops
    na = lp.frame_a * D + lp.drone_a
    nb = lp.frame_b * D + lp.drone_b
    pflat = poses.reshape(N, 4)
    ev = fx.relpose_eval(pflat[na], pflat[nb], lp.dpose, lp.sqrt_info)
    cost = cost + 0.5 * torch.sum(torch.where(
        lp.valid, fx.huber_rho(torch.sum(ev.residual ** 2, -1),
                               huber_delta), 0.0))
    ws = torch.sqrt(fx.huber_weight(ev.residual, huber_delta)) \
        * lp.valid.to(dtype)
    ja = ev.jac_a * ws[:, None, None]
    jb = ev.jac_b * ws[:, None, None]
    rl = ev.residual * ws[:, None]
    Babl = _jtj_pairs(ja, jb)
    blk = torch.cat([_jtj_pairs(ja, ja), _jtj_pairs(jb, jb), Babl,
                     Babl.mT])                           # (4L, 4, 4)
    rows = torch.cat([na, nb, na, nb])
    cols = torch.cat([na, nb, nb, na])
    ar4 = torch.arange(4, device=dev)
    H.view(N, 4, N, 4).index_put_(
        (rows[:, None, None], ar4[None, :, None], cols[:, None, None],
         ar4[None, None, :]), blk, accumulate=True)
    gflat = gvec.reshape(N, 4)
    gflat.index_put_((torch.cat([na, nb]),),
                     torch.cat([_jtr(ja, rl), _jtr(jb, rl)]),
                     accumulate=True)
    g = gflat.reshape(P)
    if axis is not None:
        H, g, cost = reduce_equations(axis, H, g, cost, bad)

    m = _param_mask(graph, dtype)
    H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    return H, g * m, cost


def _dense_problem(graph, poses0, device):
    from omniswarm_torch.convert import dense_graph_to_torch

    dev = resolve_device(device)
    return dense_graph_to_torch(graph, dev), poses_to_device(poses0, dev)


@highp()
def lm_solve_dense(graph: DenseGraph, poses0, *, device="cuda",
                   max_iterations: int = 100, huber_delta: float = 1.0,
                   det_sphere_std: float = 0.1, det_inv_dep_std: float = 0.5,
                   function_tolerance: float = 1e-6,
                   axis=None) -> SolveResult:
    """LM on the dense (P, P) Hessian (``assemble_dense``), dense Cholesky
    steps; the gold path for ``lm_solve_bt``. ``axis``: the factor-sharded
    mode of ``gauss_newton.lm_solve`` (``graph`` masked to this rank's
    factors, solved on ``axis.device``)."""
    graph, poses0 = _dense_problem(
        graph, poses0, device if axis is None else axis.device)
    assemble = functools.partial(
        assemble_dense, graph, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std,
        axis=axis)
    return run_lm_loop(assemble, poses0, max_iterations=max_iterations,
                       function_tolerance=function_tolerance,
                       sharded=axis is not None)


@highp()
def lm_solve_dense_batched(graph: DenseGraph, poses0_batch, *,
                           device="cuda", max_iterations: int = 100,
                           huber_delta: float = 1.0,
                           det_sphere_std: float = 0.1,
                           det_inv_dep_std: float = 0.5,
                           function_tolerance: float = 1e-6) -> SolveResult:
    """B instances of the dense LM on one graph, in lock-step.

    One batched Cholesky per iteration; the iteration count is shared and
    a lane that is done stops accepting steps and keeps its λ. The loop
    ends when every lane is done or at ``max_iterations``.
    """
    graph, poses = _dense_problem(graph, poses0_batch, device)

    def assemble(batch):
        H, g, c = zip(*(assemble_dense(
            graph, p, huber_delta=huber_delta, det_sphere_std=det_sphere_std,
            det_inv_dep_std=det_inv_dep_std) for p in batch))
        return torch.stack(H), torch.stack(g), torch.stack(c)

    H, g, cost = assemble(poses)
    cost0 = cost
    B = poses.shape[0]
    lam = torch.full((B,), 1e-4, dtype=poses.dtype, device=poses.device)
    done = torch.zeros((B,), dtype=torch.bool, device=poses.device)
    it = 0
    while not bool(done.all()) and it < max_iterations:
        dx, bad = damped_cholesky_step(H, g, lam)
        new_poses = _apply_step(poses, dx)
        Hn, gn, new_cost = assemble(new_poses)
        accept = torch.isfinite(new_cost) & (new_cost < cost) & ~bad & ~done
        poses = torch.where(accept[:, None, None, None], new_poses, poses)
        H = torch.where(accept[:, None, None], Hn, H)
        g = torch.where(accept[:, None], gn, g)
        converged = accept & (cost - new_cost <= function_tolerance * cost)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(done, lam, torch.clamp(
            torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e10))
        stalled = ~accept & (lam >= 1e9)
        done = done | converged | stalled
        it += 1
    return SolveResult(poses=poses, cost=cost, initial_cost=cost0,
                       iterations=it, lam=lam)


# ---------------------------------------------------------------------------
# Analytic residuals, Jacobians and the block-form normal equations
# ---------------------------------------------------------------------------

def _relpose_terms_analytic(pa, pb, dpose_meas, sqrt_info):
    """Batched analytic residual + Jacobians for 4-DoF relpose factors.

    e = meas - delta(a, b), r = S e, J = S @ (de/dpose).
    Shapes: pa/pb/dpose (L, 4), sqrt_info (L, 4, 4) -> r (L, 4),
    Ja/Jb (L, 4, 4).
    """
    delta = geo.delta_pose(pa, pb)
    e = dpose_meas - delta
    e = torch.cat([e[..., :3], geo.normalize_angle(e[..., 3:])], -1)
    r = torch.sum(sqrt_info * e[:, None, :], -1)

    c = torch.cos(pa[..., 3])
    sn = torch.sin(pa[..., 3])
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    dx_, dy_ = delta[..., 0], delta[..., 1]
    Ua = torch.stack([
        torch.stack([c, sn, zero, -dy_], -1),
        torch.stack([-sn, c, zero, dx_], -1),
        torch.stack([zero, zero, one, zero], -1),
        torch.stack([zero, zero, zero, one], -1),
    ], -2)
    Ub = torch.stack([
        torch.stack([-c, -sn, zero, zero], -1),
        torch.stack([sn, -c, zero, zero], -1),
        torch.stack([zero, zero, -one, zero], -1),
        torch.stack([zero, zero, zero, -one], -1),
    ], -2)
    Ja = torch.sum(sqrt_info[:, :, :, None] * Ua[:, None, :, :], 2)
    Jb = torch.sum(sqrt_info[:, :, :, None] * Ub[:, None, :, :], 2)
    return r, Ja, Jb


def _jtj(X, Y):
    """sum_k X[k, i] Y[k, j] over the leading residual axis."""
    return torch.sum(X[:, :, None] * Y[:, None, :], 0)


def assemble_blocks(graph: DenseGraph, poses: torch.Tensor, *,
                    huber_delta: float = 1.0, det_sphere_std: float = 0.1,
                    det_inv_dep_std: float = 0.5, loops_dense: bool = True):
    """Normal equations in frame-block form.

    Returns (A (F, m, m) diagonal blocks, Boff (F-1, m, m) odometry
    off-diagonals, g (F, m), U (F, m, 4L) loop Jacobian columns, cost) with
    m = 4D; the Hessian is T + U U^T with T block-tridiagonal. Intermediates
    keep the reference's frame-minor layout (..., F); small contractions are
    elementwise products and sums, so nothing here can run in TF32. The
    loop columns are scattered with ``index_put_(accumulate=True)``; the
    loops' gradient is one product with them (``U @ r``), whose sum has a
    fixed order on the card, where a scatter-add over shared frame rows
    would be a float atomic.

    ``loops_dense=False`` returns a ``SparseLoops`` in U's place (the PCG
    path: no (F, m, 4L) columns); its gradient rows and loop diagonal are
    sort-based scatter-adds.
    """
    F, D = graph.pose_valid.shape
    m = 4 * D
    dtype, dev = poses.dtype, poses.device
    delta = huber_delta

    p = poses.permute(2, 1, 0)                           # (4, D, F)
    t = p[:3]                                            # (3, D, F)
    ya = p[3]                                            # (D, F)

    # --- UWB ranges: pair grid (i, j, Da, Db, F) ------------------------
    diff = t[:, :, None, :] - t[:, None, :, :]           # (3, Da, Db, F)
    si = graph.range_sqrt_inf.to(dtype)
    if si.ndim:
        si = si.permute(1, 2, 0)
    rvalid = graph.range_valid.permute(1, 2, 0)
    if graph.ant_pos is None:
        diffr = diff
    else:
        # range between antenna phase centers t + R(yaw) ant
        ant = graph.ant_pos.to(dtype)                    # (D, 3)
        ca_ = torch.cos(ya)                              # (D, F)
        sa_ = torch.sin(ya)
        rot = torch.stack([ca_ * ant[:, 0, None] - sa_ * ant[:, 1, None],
                           sa_ * ant[:, 0, None] + ca_ * ant[:, 1, None],
                           ant[:, 2, None].expand(ya.shape)], 0)
        teff = t + rot                                   # (3, D, F)
        diffr = teff[:, :, None, :] - teff[:, None, :, :]
    dist = torch.sqrt(torch.sum(diffr * diffr, 0) + 1e-12)   # (Da, Db, F)
    r_r = (dist - graph.range_dist.permute(1, 2, 0)) * si
    u_r = diffr / dist[None]
    w_r = torch.where(torch.abs(r_r) <= delta, 1.0,
                      delta / torch.clamp_min(torch.abs(r_r), 1e-12))
    w_r = w_r * rvalid.to(dtype)
    cost = 0.5 * torch.sum(torch.where(rvalid,
                                       fx.huber_rho(r_r * r_r, delta), 0.0))

    Hp = torch.zeros((4, 4, D, D, F), dtype=dtype, device=dev)
    diag = torch.zeros((4, 4, D, F), dtype=dtype, device=dev)
    g = torch.zeros((4, D, F), dtype=dtype, device=dev)

    if graph.ant_pos is None:
        su = u_r * si
        wB = su[:, None] * su[None, :] * w_r[None, None]  # (3, 3, Da, Db, F)
        wB_sym = wB + wB.permute(0, 1, 3, 2, 4)
        Hp[:3, :3] -= wB_sym
        diag[:3, :3] += torch.sum(wB_sym, 3)
        gr = su * (w_r * r_r)[None]
        g[:3] += torch.sum(gr - gr.permute(0, 2, 1, 3), 2)
    else:
        # ka != kb breaks the antisymmetric shortcut: general 4-row form
        dRr = torch.stack([-sa_ * ant[:, 0, None] - ca_ * ant[:, 1, None],
                           ca_ * ant[:, 0, None] - sa_ * ant[:, 1, None],
                           torch.zeros_like(ya)], 0)     # (3, D, F)
        ka = torch.sum(u_r * dRr[:, :, None, :], 0)      # (Da, Db, F)
        kb = torch.sum(u_r * dRr[:, None, :, :], 0)
        ja_r = torch.cat([u_r, ka[None]], 0) * si        # (4, Da, Db, F)
        jb_r = -torch.cat([u_r, kb[None]], 0) * si
        wja_r = ja_r * w_r[None]
        wjb_r = jb_r * w_r[None]
        diag += torch.sum(wja_r[:, None] * ja_r[None, :], 3)
        diag += torch.sum(wjb_r[:, None] * jb_r[None, :], 2)
        cross_r = wja_r[:, None] * jb_r[None, :]         # (ia, jb, Da, Db, F)
        Hp += cross_r + cross_r.permute(1, 0, 3, 2, 4)
        g += torch.sum(wja_r * r_r[None], 2)
        g += torch.sum(wjb_r * r_r[None], 1)

    # --- detections: bearing + inverse depth ----------------------------
    if graph.det_dir is not None:
        ddir = graph.det_dir.permute(3, 1, 2, 0)         # (3, Da, Db, F)
        dtb = graph.det_tb.permute(3, 4, 1, 2, 0)        # (2, 3, Da, Db, F)
        dinv = graph.det_invdep.permute(1, 2, 0)
        dvalid = graph.det_valid.permute(1, 2, 0)
        dhas = graph.det_has_depth.permute(1, 2, 0).to(dtype)
        c = torch.cos(ya)[:, None, :]                    # (Da, 1, F)
        s = torch.sin(ya)[:, None, :]
        diffb = -diff                                    # b - a
        relx = c * diffb[0] + s * diffb[1]
        rely = -s * diffb[0] + c * diffb[1]
        rel = torch.stack([relx, rely, diffb[2]], 0)     # (3, Da, Db, F)
        n = torch.sqrt(torch.sum(rel * rel, 0) + 1e-12)
        unit = rel / n[None]
        err3 = unit - ddir
        res01 = torch.sum(dtb * err3[None], 1) / det_sphere_std
        res2 = (dinv - 1.0 / n) / det_inv_dep_std * dhas
        rd = torch.cat([res01, res2[None]], 0)           # (3k, Da, Db, F)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        P = (eye3[:, :, None, None, None]
             - unit[:, None] * unit[None, :]) / n[None, None]
        dres01 = torch.sum(dtb[:, :, None] * P[None], 1) / det_sphere_std
        dres2 = unit / (n * n)[None] / det_inv_dep_std * dhas[None]
        dres = torch.cat([dres01, dres2[None]], 0)       # (3k, 3i, Da, Db, F)
        Jb0 = dres[:, 0] * c + dres[:, 1] * (-s)         # chain through R(-ya)
        Jb1 = dres[:, 0] * s + dres[:, 1] * c
        Jb2 = dres[:, 2]
        drel_dya = torch.stack([rely, -relx, torch.zeros_like(relx)], 0)
        Jya = torch.sum(dres * drel_dya[None, :], 1)     # (3k, Da, Db, F)
        Jb_d = torch.stack([Jb0, Jb1, Jb2, torch.zeros_like(Jb0)], 1)
        Ja_d = torch.stack([-Jb0, -Jb1, -Jb2, Jya], 1)   # (k, 4i, Da, Db, F)
        normd = torch.sqrt(torch.sum(rd * rd, 0) + 1e-20)
        w_d = torch.where(normd <= delta, 1.0,
                          delta / torch.clamp_min(normd, 1e-12))
        w_d = w_d * dvalid.to(dtype)
        cost = cost + 0.5 * torch.sum(torch.where(
            dvalid, fx.huber_rho(normd * normd, delta), 0.0))
        wJa = Ja_d * w_d[None, None]
        wJb = Jb_d * w_d[None, None]
        diag += torch.sum(_jtj(wJa, Ja_d), 3)            # at a (sum Db)
        diag += torch.sum(_jtj(wJb, Jb_d), 2)            # at b (sum Da)
        Bab = _jtj(wJa, Jb_d)                            # (ia, jb, Da, Db, F)
        Hp += Bab + Bab.permute(1, 0, 3, 2, 4)
        g += torch.sum(torch.sum(wJa * rd[:, None], 0), 2)
        g += torch.sum(torch.sum(wJb * rd[:, None], 0), 1)

    # --- ego-motion chain (frame axis F-1, still minor) ------------------
    om = graph.odom_dpose.permute(2, 1, 0)               # (4, D, F-1)
    osi = graph.odom_sqrt_info.permute(2, 1, 0)
    ovalid = graph.odom_valid.permute(1, 0).to(dtype)    # (D, F-1)
    ta, tb = t[..., :-1], t[..., 1:]
    yaa, yab = ya[..., :-1], ya[..., 1:]
    co = torch.cos(yaa)
    so = torch.sin(yaa)
    dxw = tb[0] - ta[0]
    dyw = tb[1] - ta[1]
    dx_ = co * dxw + so * dyw
    dy_ = -so * dxw + co * dyw
    dz_ = tb[2] - ta[2]
    dyaw = geo.normalize_angle(yab - yaa)
    e = torch.stack([om[0] - dx_, om[1] - dy_, om[2] - dz_,
                     geo.normalize_angle(om[3] - dyaw)], 0)  # (4, D, F-1)
    r_o = osi * e
    cost = cost + 0.5 * torch.sum(ovalid * torch.sum(r_o * r_o, 0))
    zo = torch.zeros_like(co)
    one = torch.ones_like(co)
    # rows k, cols i; scaled by osi[k]
    Ja_o = torch.stack([
        torch.stack([co, so, zo, -dy_], 0),
        torch.stack([-so, co, zo, dx_], 0),
        torch.stack([zo, zo, one, zo], 0),
        torch.stack([zo, zo, zo, one], 0),
    ], 0) * osi[:, None]                                 # (4k, 4i, D, F-1)
    Jb_o = torch.stack([
        torch.stack([-co, -so, zo, zo], 0),
        torch.stack([so, -co, zo, zo], 0),
        torch.stack([zo, zo, -one, zo], 0),
        torch.stack([zo, zo, zo, -one], 0),
    ], 0) * osi[:, None]
    wJa_o = Ja_o * ovalid[None, None]
    wJb_o = Jb_o * ovalid[None, None]
    diag[..., :-1] += _jtj(wJa_o, Ja_o)
    diag[..., 1:] += _jtj(wJb_o, Jb_o)
    Bab_o = _jtj(wJa_o, Jb_o)                            # (ia, jb, D, F-1)
    g[..., :-1] += torch.sum(wJa_o * r_o[:, None], 0)
    g[..., 1:] += torch.sum(wJb_o * r_o[:, None], 0)

    # param mask at (F, D, 4) granularity
    free = graph.pose_valid & ~graph.pose_fixed
    mask4 = torch.cat([free[..., None].expand(F, D, 3),
                       (free & ~graph.yaw_fixed)[..., None]], -1)
    mflat = mask4.reshape(F, m).to(dtype)                # (F, m)

    # embed per-pose diag on a==b, then one transpose to (F, m, m)
    Hp.diagonal(dim1=2, dim2=3).add_(diag.permute(0, 1, 3, 2))
    A = Hp.permute(4, 2, 0, 3, 1).reshape(F, m, m)
    gvec = g.permute(2, 1, 0)                            # (F, D, 4)

    # odometry off-diagonal frame blocks (block-diagonal over drones)
    Bp = torch.zeros((4, 4, D, D, F - 1), dtype=dtype, device=dev)
    Bp.diagonal(dim1=2, dim2=3).copy_(Bab_o.permute(0, 1, 3, 2))
    Boff = Bp.permute(4, 2, 0, 3, 1).reshape(F - 1, m, m)

    # sparse loop factors -> low-rank columns U (F, m, 4L) + g additions
    lp = graph.loops
    L = lp.valid.shape[0]
    poses_flat = poses.reshape(F * D, 4)
    pa = poses_flat[lp.frame_a * D + lp.drone_a]
    pb = poses_flat[lp.frame_b * D + lp.drone_b]
    r_l, Ja_l, Jb_l = _relpose_terms_analytic(pa, pb, lp.dpose, lp.sqrt_info)
    w_l = fx.huber_weight(r_l, huber_delta)
    cost = cost + 0.5 * torch.sum(torch.where(
        lp.valid, fx.huber_rho(torch.sum(r_l * r_l, -1), huber_delta), 0.0))
    ws = torch.sqrt(w_l) * lp.valid.to(dtype)
    ja = Ja_l * ws[:, None, None]                        # (L, 4, 4) rows m
    jb = Jb_l * ws[:, None, None]
    rl = r_l * ws[:, None]

    ar4 = torch.arange(4, device=dev)
    grow_a = lp.frame_a[:, None] * m + lp.drone_a[:, None] * 4 + ar4[None]
    grow_b = lp.frame_b[:, None] * m + lp.drone_b[:, None] * 4 + ar4[None]
    eye_m = torch.eye(m, dtype=dtype, device=dev)

    def masked(A, Boff, g):
        """zero masked rows/cols, unit diagonal on masked entries"""
        A = A * mflat[:, :, None] * mflat[:, None, :]
        A = A + eye_m[None] * (1.0 - mflat)[:, :, None] * eye_m[None]
        Boff = Boff * mflat[:-1, :, None] * mflat[1:, None, :]
        return A, Boff, g * mflat

    if not loops_dense:
        rows2 = torch.cat([grow_a, grow_b]).reshape(-1)
        gl = torch.zeros((F * m,), dtype=dtype, device=dev)
        gl.index_put_((rows2,), torch.cat([torch.sum(ja * rl[..., None], 1),
                                           torch.sum(jb * rl[..., None], 1)]
                                          ).reshape(-1), accumulate=True)
        A, Boff, gflat = masked(A, Boff, gvec.reshape(F, m)
                                + gl.reshape(F, m))
        mf = mflat.reshape(-1)
        ja_s = ja * mf[grow_a][:, None, :]
        jb_s = jb * mf[grow_b][:, None, :]
        diagU = torch.zeros((F * m,), dtype=dtype, device=dev)
        diagU.index_put_((rows2,), torch.cat([torch.sum(ja_s * ja_s, 1),
                                              torch.sum(jb_s * jb_s, 1)]
                                             ).reshape(-1), accumulate=True)
        sparse = SparseLoops(ja=ja_s, jb=jb_s, rows_a=grow_a, rows_b=grow_b,
                             diag=diagU.reshape(F, m))
        return A, Boff, gflat, sparse, cost

    # U[f, d*4+i, 4k+c] += J^T entries for each loop endpoint
    U = torch.zeros((F * m, 4 * L), dtype=dtype, device=dev)
    col = (torch.arange(L, device=dev)[:, None, None] * 4
           + ar4[None, :, None]).expand(L, 4, 4)         # (L, 4c, 4i)
    row_a = grow_a[:, None, :].expand(L, 4, 4)
    row_b = grow_b[:, None, :].expand(L, 4, 4)
    # ja[k, c, i] goes to U[row_a[k, c, i], col[k, c, i]]
    U.index_put_((row_a.reshape(-1), col.reshape(-1)), ja.reshape(-1),
                 accumulate=True)
    U.index_put_((row_b.reshape(-1), col.reshape(-1)), jb.reshape(-1),
                 accumulate=True)
    # the loops' gradient J^T r: one product, so the sum over loops that
    # share frame rows has the same order in every run
    gflat = gvec.reshape(F, m) + (U @ rl.reshape(4 * L)).reshape(F, m)
    A, Boff, gflat = masked(A, Boff, gflat)
    U = U.reshape(F, m, 4 * L) * mflat[:, :, None]
    return A, Boff, gflat, U, cost


class SparseLoops(NamedTuple):
    """Loop factors in sparse endpoint-block form (the PCG path): ja/jb
    (L, 4, 4) weighted, masked Jacobian blocks (residual row, param col),
    rows_a/rows_b (L, 4) flat row indices into the (F*m,) state, diag
    (F, m) the loop term's Gauss-Newton diagonal."""

    ja: torch.Tensor
    jb: torch.Tensor
    rows_a: torch.Tensor
    rows_b: torch.Tensor
    diag: torch.Tensor


# ---------------------------------------------------------------------------
# Linear solves (Woodbury, exact Woodbury, sparse-loop PCG) and the LM loops
# ---------------------------------------------------------------------------

def _damped(A, extra_diag, lam):
    """A + lam * max(diag(A) + extra_diag, 1e-6) on the block diagonals."""
    m = A.shape[-1]
    d = lam * torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1)
                              + extra_diag, 1e-6)
    return A + d[..., None] * torch.eye(m, dtype=A.dtype,
                                        device=A.device)[None]


@highp()
def _smw_solve_core(A, Boff, g, U, lam, warm=None, *, exact: bool = False,
                    pack: int = 1, fused_levels: bool = False):
    """Damped (T + U U^T) dx = -g by a block-tridiagonal solve + Woodbury.

    exact=False (the LM fast path): the Newton-Schulz cyclic reduction
    (bt_factor / bt_apply) sweeps the gradient column in f32 and the C
    Woodbury columns in bf16; the capacitance S and the final correction
    accumulate in f32 (bf16 operands are upcast, which is exact); S is
    inverted by bf16 Newton-Schulz with two f32 refinement passes. ``warm``
    threads (level inverses, tail inverse, capacitance inverse) across LM
    iterations; pass None for a cold start.

    exact=True: [-g | U] through the exact Cholesky ``bt_solve`` and S by
    Cholesky (NaN when a block or S is not positive definite); ``warm`` is
    ignored and ``()`` returned.

    Returns ``(dx, warm_out)``.
    """
    F, m = A.shape[0], A.shape[1]
    C = U.shape[-1]
    Uf = U.float()
    Ad = _damped(A, torch.sum(Uf * Uf, -1), lam)
    if exact:
        Y = bt_solve(Ad, Boff, torch.cat([-g[..., None], Uf], -1))
        yb, YU = Y[..., 0], Y[..., 1:]
    else:
        if pack > 1:
            Adp, Bp, _ = pack_bt_mats(Ad, Boff, pack)
            gp = pack_bt_cols(g[..., None], pack)
            Up = pack_bt_cols(U, pack)
        else:
            Adp, Bp, gp, Up = Ad, Boff, g[..., None], U
        # packed blocks are worse conditioned: deeper cold Newton-Schulz
        fac = bt_factor(Adp, Bp, ns_iters=8 if pack == 1 else 12,
                        direct_threshold=4,
                        warm=None if warm is None else warm[:2],
                        fused=fused_levels)
        yb_p = bt_apply(fac, -gp)
        YU_p = bt_apply(fac, Up.to(torch.bfloat16))       # stays bf16
        if pack > 1:
            yb = unpack_bt_cols(yb_p, pack, F)[..., 0]
            YU = unpack_bt_cols(YU_p, pack, F)
        else:
            yb, YU = yb_p[..., 0], YU_p
    YUf = YU.float().reshape(F * m, C)
    S = torch.eye(C, dtype=A.dtype, device=A.device) + (
        U.to(YU.dtype).float().reshape(F * m, C).mT @ YUf)
    Uyb = Uf.reshape(F * m, C).mT @ yb.to(U.dtype).float().reshape(F * m)
    if exact:
        z = cholesky_solve_checked(S, Uyb[:, None])[:, 0]
        warm_out = ()
    else:
        Xf = spd_ns_inverse(S, None if warm is None else warm[2])
        z = Xf @ Uyb
        for _ in range(2):
            r = Uyb - S @ z
            z = z + Xf @ r
        warm_out = bt_warm_state(fac) + (Xf,)
    dx = yb.reshape(F * m) - YUf @ z.to(YU.dtype).float()
    return dx, warm_out


def _endpoint_blocks(sl: SparseLoops):
    """(jab (2L, 4, 4), rows2 (2L, 4)): both endpoints' blocks, a-side
    first."""
    return (torch.cat([sl.ja, sl.jb], 0), torch.cat([sl.rows_a, sl.rows_b], 0))


def loop_matvec(jab: torch.Tensor, rows2: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """J_loops^T J_loops v for a flat (F*m,) v, from the endpoint blocks:
    gather the two endpoints, J_a v_a + J_b v_b per loop, then one
    sort-based scatter-add of J^T of it back to both endpoints."""
    L = jab.shape[0] // 2
    th = torch.sum(jab * v[rows2][:, None, :], -1)         # (2L, 4)
    t2 = th[:L] + th[L:]                                   # J_a v + J_b v
    contrib = torch.sum(jab * torch.cat([t2, t2], 0)[..., None], 1)
    out = torch.zeros_like(v)
    out.index_put_((rows2.reshape(-1),), contrib.reshape(-1), accumulate=True)
    return out


@highp()
def _pcg_solve_core(A, Boff, g, sl: SparseLoops, lam, warm=None, *,
                    pack: int = 1, fused_levels: bool = False,
                    cg_iters: int = 24):
    """Damped (T + J_loops^T J_loops) dx = -g by preconditioned CG.

    The loop term is applied sparsely (gather the two endpoint blocks, two
    (2L, 4, 4) contractions, one sort-based scatter-add) inside a
    fixed-trip-count CG (no early exit) preconditioned by the Newton-Schulz
    cyclic-reduction factor of T, which takes fused levels (K1) when packed
    and warm. The damping uses diag(T) + the loop diagonal. CG starts from
    ``warm[2]`` (the previous step) when given, else from 0; a non-finite x
    falls back to 0. Returns ``(dx, (level inverses, tail inverse, x))``.
    """
    F, m = A.shape[0], A.shape[1]
    Ad = _damped(A, sl.diag, lam)
    if pack > 1:
        Adp, Bp, _ = pack_bt_mats(Ad, Boff, pack)
    else:
        Adp, Bp = Ad, Boff
    fac = bt_factor(Adp, Bp, ns_iters=8 if pack == 1 else 12,
                    direct_threshold=4,
                    warm=None if warm is None else warm[:2],
                    fused=fused_levels)

    def precond(r):
        rp = pack_bt_cols(r[..., None], pack) if pack > 1 else r[..., None]
        y = bt_apply(fac, rp)
        return (unpack_bt_cols(y, pack, F) if pack > 1 else y)[..., 0]

    # endpoint blocks concatenated once: one gather and one scatter a matvec
    jab, rows2 = _endpoint_blocks(sl)

    def hmul(v):
        """Damped-Hessian matvec: the BT part + the sparse loop part."""
        y = (Ad @ v[..., None])[..., 0]
        y = y + torch.cat([(Boff @ v[1:, :, None])[..., 0],
                           torch.zeros_like(v[:1])], 0)
        y = y + torch.cat([torch.zeros_like(v[:1]),
                           (Boff.mT @ v[:-1, :, None])[..., 0]], 0)
        return y + loop_matvec(jab, rows2, v.reshape(-1)).reshape(F, m)

    b = -g
    if warm is None or len(warm) < 3:
        x = torch.zeros_like(b)
        r = b
    else:
        x = warm[2]
        r = b - hmul(x)
    z = precond(r)
    p_ = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        hp = hmul(p_)
        alpha = rz / torch.clamp_min(torch.sum(p_ * hp), 1e-30)
        x = x + alpha * p_
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p_ = z + beta * p_
        rz = rz_new
    x = torch.where(torch.all(torch.isfinite(x)), x, torch.zeros_like(x))
    return x.reshape(-1), bt_warm_state(fac) + (x,)


def _auto_pack(F: int, m: int = 20) -> int:
    """Frames per block for the cyclic reduction (reference rule): 1 below
    F=96, up to 40-wide blocks below F=384, up to 80-wide above."""
    if F < 96:
        return 1
    if F < 384:
        return min(2, max(1, 40 // max(m, 1)))
    return max(1, min(4, 80 // max(m, 1)))


def _select(accept, new, old):
    """new where ``accept`` (one flag, or one per leading lane) else old,
    leaf by leaf over tensors and SparseLoops."""
    if isinstance(new, SparseLoops):
        return SparseLoops(*(_select(accept, n, o) for n, o in zip(new, old)))
    flag = accept.reshape(accept.shape + (1,) * (new.ndim - accept.ndim))
    return torch.where(flag, new.to(old.dtype), old)


def uses_pcg(linear: str, exact_linear: bool, F: int, Lb: int) -> bool:
    """Whether ``lm_solve_bt`` takes PCG: asked for, or ``"auto"`` (not
    exact) once 4 x the loop capacity Lb or F exceeds 4096."""
    return linear == "pcg" or (linear == "auto" and not exact_linear
                               and (4 * Lb > 4096 or F > 4096))


@highp()
def lm_solve_bt(graph: DenseGraph, poses0, *, device="cuda",
                max_iterations: int = 100, huber_delta: float = 1.0,
                det_sphere_std: float = 0.1, det_inv_dep_std: float = 0.5,
                function_tolerance: float = 1e-6,
                exact_linear: bool = False, pack: Optional[int] = None,
                fused: Optional[bool] = None,
                linear: str = "auto", cg_iters: int = 24) -> SolveResult:
    """LM with the block-tridiagonal linear solvers.

    ``graph``: a DenseGraph with numpy or tensor leaves (moved to
    ``device``); ``poses0``: (F, D, 4) initial poses. ``linear``: "smw"
    (Woodbury on the capacitance), "pcg" (BT-preconditioned CG, ``cg_iters``
    sweeps, loops applied sparsely) or "auto": pcg once 4L > 4096 or
    F > 4096, unless ``exact_linear`` (Woodbury on the exact Cholesky
    ``bt_solve``). ``pack`` overrides the frames-per-block choice (default
    ``_auto_pack``); ``fused`` overrides the fused-level choice (default:
    on when pack > 1). A cold factorization seeds the warm Newton-Schulz
    chain (on the PCG path with one CG sweep); λ starts at 1e-4 and goes
    ×0.3 on accept, ×5 on reject, clipped to [1e-10, 1e10]. The loop ends at
    ``max_iterations``, on convergence (an accepted step that lowers the
    cost by at most ``function_tolerance`` relative) or on a stall (a
    reject with λ >= 1e9); the done flag is read on the host once per
    iteration.
    """
    if linear not in ("auto", "smw", "pcg"):
        raise ValueError(f"unknown linear solver {linear!r}")
    graph, poses0 = _dense_problem(graph, poses0, device)
    F, D = graph.pose_valid.shape
    use_pcg = uses_pcg(linear, exact_linear, F, graph.loops.valid.shape[0])

    assemble = functools.partial(
        assemble_blocks, graph, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std,
        loops_dense=not use_pcg)
    A, B, g, U, cost = assemble(poses0)
    if not exact_linear and not use_pcg:
        # the Woodbury columns sweep in bf16 anyway; carry U in bf16
        U = U.to(torch.bfloat16)
    cost0 = cost

    pk = _auto_pack(F, 4 * D) if pack is None else pack
    fused_levels = (pk > 1) if fused is None else fused
    lam = torch.tensor(1e-4, dtype=poses0.dtype, device=poses0.device)
    # a cold factorization seeds the warm chain (dx discarded)
    if use_pcg:
        solve = functools.partial(_pcg_solve_core, pack=pk,
                                  cg_iters=cg_iters,
                                  fused_levels=fused_levels)
        _, warm = _pcg_solve_core(A, B, g, U, lam, None, pack=pk,
                                  cg_iters=1, fused_levels=fused_levels)
    else:
        solve = functools.partial(_smw_solve_core, exact=exact_linear,
                                  pack=pk, fused_levels=fused_levels)
        _, warm = solve(A, B, g, U, lam, None)

    poses = poses0
    it = 0
    done = False
    while not done and it < max_iterations:
        dx, warm = solve(A, B, g, U, lam, warm)
        bad = ~torch.all(torch.isfinite(dx))
        new_poses = _apply_step(poses, torch.where(bad, 0.0, dx))
        An, Bn, gn, Un, new_cost = assemble(new_poses)
        accept = torch.isfinite(new_cost) & (new_cost < cost) & ~bad
        poses, A, B, g, U = (_select(accept, n, o) for n, o in zip(
            (new_poses, An, Bn, gn, Un), (poses, A, B, g, U)))
        converged = accept & (cost - new_cost <= function_tolerance * cost)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-10, 1e10)
        stalled = ~accept & (lam >= 1e9)
        it += 1
        done = bool(converged | stalled)
    return SolveResult(poses=poses, cost=cost, initial_cost=cost0,
                       iterations=it, lam=lam)


def _lane(graph: DenseGraph, b: int) -> DenseGraph:
    """Lane b of a stacked DenseGraph."""
    return DenseGraph(*(None if v is None else
                        RelPoseFactors(*(x[b] for x in v))
                        if isinstance(v, RelPoseFactors) else v[b]
                        for v in graph))


def assemble_lanes(lanes, poses, **kw):
    """``assemble_blocks`` of each lane's graph at its poses, stacked: the
    batched LM's assembly (``kw``: the residuals' parameters)."""
    outs = [assemble_blocks(gr, p, **kw) for gr, p in zip(lanes, poses)]
    return [torch.stack(x) for x in zip(*outs)]


def smw_lanes(A, Boff, g, U, lam, warm, **kw):
    """``_smw_solve_core`` of each lane (``kw``: its keywords), stacked:
    the batched LM's linear solve. Returns (dx (B, F*m), the lanes' warm
    states)."""
    outs = [_smw_solve_core(*args, **kw)
            for args in zip(A, Boff, g, U, lam, warm)]
    dx, warm = zip(*outs)
    return torch.stack(dx), list(warm)


@highp()
def lm_solve_bt_batched(graph: DenseGraph, poses0_batch, *, device="cuda",
                        max_iterations: int = 100, huber_delta: float = 1.0,
                        det_sphere_std: float = 0.1,
                        det_inv_dep_std: float = 0.5,
                        function_tolerance: float = 1e-6,
                        exact_linear: bool = False,
                        pack: Optional[int] = None) -> SolveResult:
    """B instances of the block-tridiagonal LM in lock-step.

    ``graph`` is one DenseGraph shared by every lane (multi-init trials) or
    a stacked one with a leading lane axis matching ``poses0_batch``
    (B, F, D, 4) (one problem per lane). Each lane's assembly and Woodbury
    solve are the single solve's (unfused levels); the iteration count is
    shared, and a lane that is done stops accepting steps and keeps its λ.
    The loop ends when every lane is done or at ``max_iterations``.
    """
    graph, poses = _dense_problem(graph, poses0_batch, device)
    B = poses.shape[0]
    stacked = graph.pose_valid.ndim == 3
    lanes = [_lane(graph, b) if stacked else graph for b in range(B)]
    F, D = lanes[0].pose_valid.shape
    pk = _auto_pack(F, 4 * D) if pack is None else pack

    assemble = functools.partial(
        assemble_lanes, lanes, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std)
    solve = functools.partial(smw_lanes, exact=exact_linear, pack=pk)

    A, Boff, g, U, cost = assemble(poses)
    if not exact_linear:
        U = U.to(torch.bfloat16)
    cost0 = cost
    lam = torch.full((B,), 1e-4, dtype=poses.dtype, device=poses.device)
    _, warm = solve(A, Boff, g, U, lam, [None] * B)
    done = torch.zeros((B,), dtype=torch.bool, device=poses.device)
    it = 0
    while not bool(done.all()) and it < max_iterations:
        dx, warm = solve(A, Boff, g, U, lam, warm)
        bad = ~torch.all(torch.isfinite(dx), -1)
        new_poses = _apply_step(poses, torch.where(bad[:, None], 0.0, dx))
        An, Bn, gn, Un, new_cost = assemble(new_poses)
        accept = torch.isfinite(new_cost) & (new_cost < cost) & ~bad & ~done
        poses, A, Boff, g, U = (_select(accept, n, o) for n, o in zip(
            (new_poses, An, Bn, gn, Un), (poses, A, Boff, g, U)))
        converged = accept & (cost - new_cost <= function_tolerance * cost)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(done, lam, torch.clamp(
            torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e10))
        stalled = ~accept & (lam >= 1e9) & ~done
        done = done | converged | stalled
        it += 1
    return SolveResult(poses=poses, cost=cost, initial_cost=cost0,
                       iterations=it, lam=lam)


@highp()
def pose_covariances(graph: DenseGraph, poses, query, *, device="cuda",
                     huber_delta: float = 1.0, det_sphere_std: float = 0.1,
                     det_inv_dep_std: float = 0.5) -> torch.Tensor:
    """Marginal 4x4 covariances of selected poses at the solution.

    ``query``: (Q, 2) (frame, drone) indices. Returns (Q, 4, 4) blocks of
    H^-1 through the exact ``bt_solve`` + Woodbury, each query pose four
    unit-vector right-hand sides. A scale-relative ridge 1e-6 max|A| + 1e-12
    keeps the block Cholesky f32-safe (the BT part alone can be
    gauge-singular), and two refinement passes against the full, unridged
    H (BT matvec + U U^T) cancel its bias. Fixed or invalid parameters and
    fixed yaws get zero covariance.
    """
    graph, poses = _dense_problem(graph, poses, device)
    query = torch.as_tensor(query, dtype=torch.int64, device=poses.device)
    F, D = graph.pose_valid.shape
    m = 4 * D
    A, Boff, _, U, _ = assemble_blocks(
        graph, poses, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std)
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    Ar = A + (1e-6 * torch.max(torch.abs(A)) + 1e-12) * eye_m[None]

    Q = query.shape[0]
    ar4 = torch.arange(4, device=A.device)
    E = A.new_zeros((F, m, 4 * Q))
    E[query[:, 0, None], query[:, 1, None] * 4 + ar4[None],
      torch.arange(Q, device=A.device)[:, None] * 4 + ar4[None]] = 1.0

    C = U.shape[-1]
    Um = U.reshape(F * m, C)
    YU = bt_solve(Ar, Boff, U).reshape(F * m, C)
    S = torch.eye(C, dtype=A.dtype, device=A.device) + Um.mT @ YU
    L, info = torch.linalg.cholesky_ex(S)

    def minv(rhs):
        """(BT(Ar) + U U^T)^-1 rhs by Woodbury (YU and S's factor reused)."""
        Y = bt_solve(Ar, Boff, rhs).reshape(F * m, -1)
        W = torch.linalg.solve_triangular(L, Um.mT @ Y, upper=False)
        Z = torch.linalg.solve_triangular(L.mT, W, upper=True)
        Z = torch.where(info != 0, float("nan"), Z)
        return (Y - YU @ Z).reshape(rhs.shape)

    def happly(x):
        """Full (unridged) H x = BT(A) x + U (U^T x)."""
        return bt_matvec(A, Boff, x) + (
            Um @ (Um.mT @ x.reshape(F * m, -1))).reshape(x.shape)

    X = minv(E)
    for _ in range(2):
        X = X + minv(E - happly(X))                      # H^-1 E
    cov = E.reshape(F * m, 4 * Q).mT @ X.reshape(F * m, 4 * Q)
    idx = torch.arange(Q, device=A.device)
    out = cov.reshape(Q, 4, Q, 4)[idx, :, idx, :]        # (Q, 4, 4)
    qmask = _param_mask(graph, A.dtype).reshape(F, D, 4)[query[:, 0],
                                                         query[:, 1]]
    return out * qmask[:, :, None] * qmask[:, None, :]
