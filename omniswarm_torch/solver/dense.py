"""Frame-dense factor graph and the block-tridiagonal + Woodbury LM solve.

Counterpart of ``omniswarm_tpu/solver/dense.py``: the graph container and
its host-side construction (:36-81, :452-537), the analytic residual and
Jacobian grids with the normal equations in frame-block form
(``assemble_blocks``, :613-882, dense loop columns), the Woodbury linear
solve (``_smw_solve_core``, exact=False, :996-1093) and the LM loop
(``lm_solve_bt``, the counterpart of ``lm_solve_bt_impl``, :1115-1224).

Not in this slice (they raise ``NotImplementedError``): the sparse-loop PCG
path (``linear="pcg"``, and the choice ``"auto"`` makes for 4L > 4096 or
F > 4096) and the exact Cholesky linear solve (``exact_linear=True``).
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
    bt_apply, bt_factor, bt_warm_state, pack_bt_cols, pack_bt_mats,
    spd_ns_inverse, unpack_bt_cols)
from omniswarm_torch.solver.gauss_newton import SolveResult, _apply_step
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
                    det_inv_dep_std: float = 0.5):
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

    # apply masks: zero rows/cols, unit diagonal on masked entries
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    A = A * mflat[:, :, None] * mflat[:, None, :]
    A = A + eye_m[None] * (1.0 - mflat)[:, :, None] * eye_m[None]
    Boff = Boff * mflat[:-1, :, None] * mflat[1:, None, :]
    gflat = gflat * mflat
    U = U.reshape(F, m, 4 * L) * mflat[:, :, None]
    return A, Boff, gflat, U, cost


# ---------------------------------------------------------------------------
# Woodbury linear solve and the LM loop
# ---------------------------------------------------------------------------

@highp()
def _smw_solve_core(A, Boff, g, U, lam, warm=None, *, pack: int = 1,
                    fused_levels: bool = False):
    """Damped (T + U U^T) dx = -g by cyclic reduction + Woodbury.

    The Newton-Schulz cyclic reduction (bt_factor / bt_apply) sweeps the
    gradient column in f32 and the C Woodbury columns in bf16; the
    capacitance S and the final correction accumulate in f32 (bf16 operands
    are upcast, which is exact). Returns ``(dx, warm_out)``: ``warm``
    threads (level inverses, tail inverse, capacitance inverse) across LM
    iterations; pass None for a cold start.
    """
    F, m = A.shape[0], A.shape[1]
    C = U.shape[-1]
    Uf = U.float()
    diagT = torch.diagonal(A, dim1=-2, dim2=-1)          # (F, m)
    diagU = torch.sum(Uf * Uf, -1)                        # (F, m)
    d = lam * torch.clamp_min(diagT + diagU, 1e-6)
    Ad = A + d[..., None] * torch.eye(m, dtype=A.dtype, device=A.device)[None]
    if pack > 1:
        Adp, Bp, _ = pack_bt_mats(Ad, Boff, pack)
        gp = pack_bt_cols(g[..., None], pack)
        Up = pack_bt_cols(U, pack)
    else:
        Adp, Bp, gp, Up = Ad, Boff, g[..., None], U
    # packed blocks are worse conditioned: deeper cold Newton-Schulz chain
    fac = bt_factor(Adp, Bp, ns_iters=8 if pack == 1 else 12,
                    direct_threshold=4,
                    warm=None if warm is None else warm[:2],
                    fused=fused_levels)
    yb_p = bt_apply(fac, -gp)
    YU_p = bt_apply(fac, Up.to(torch.bfloat16))           # stays bf16
    if pack > 1:
        yb = unpack_bt_cols(yb_p, pack, F)[..., 0]
        YU = unpack_bt_cols(YU_p, pack, F)
    else:
        yb, YU = yb_p[..., 0], YU_p
    YUf = YU.float().reshape(F * m, C)
    S = torch.eye(C, dtype=A.dtype, device=A.device) + (
        U.to(YU.dtype).float().reshape(F * m, C).mT @ YUf)
    Uyb = Uf.reshape(F * m, C).mT @ yb.to(U.dtype).float().reshape(F * m)
    Xf = spd_ns_inverse(S, None if warm is None else warm[2])
    z = Xf @ Uyb
    for _ in range(2):
        r = Uyb - S @ z
        z = z + Xf @ r
    lvl, tail = bt_warm_state(fac)
    dx = yb.reshape(F * m) - YUf @ z.to(YU.dtype).float()
    return dx, (lvl, tail, Xf)


def _auto_pack(F: int, m: int = 20) -> int:
    """Frames per block for the cyclic reduction (reference rule): 1 below
    F=96, up to 40-wide blocks below F=384, up to 80-wide above."""
    if F < 96:
        return 1
    if F < 384:
        return min(2, max(1, 40 // max(m, 1)))
    return max(1, min(4, 80 // max(m, 1)))


@highp()
def lm_solve_bt(graph: DenseGraph, poses0, *, device="cuda",
                max_iterations: int = 100, huber_delta: float = 1.0,
                det_sphere_std: float = 0.1, det_inv_dep_std: float = 0.5,
                function_tolerance: float = 1e-6,
                exact_linear: bool = False, pack: Optional[int] = None,
                fused: Optional[bool] = None,
                linear: str = "auto") -> SolveResult:
    """LM with the block-tridiagonal + Woodbury linear solver.

    ``graph``: a DenseGraph with numpy or tensor leaves (moved to
    ``device``); ``poses0``: (F, D, 4) initial poses. ``pack`` overrides
    the frames-per-block choice (default ``_auto_pack``); ``fused``
    overrides the fused-level choice (default: on when pack > 1). A cold
    factorization seeds the warm Newton-Schulz chain; λ starts at 1e-4 and
    goes ×0.3 on accept, ×5 on reject, clipped to [1e-10, 1e10]. The loop
    ends at ``max_iterations``, on convergence (an accepted step that
    lowers the cost by at most ``function_tolerance`` relative) or on a
    stall (a reject with λ >= 1e9); the done flag is read on the host once
    per iteration.
    """
    from omniswarm_torch.convert import dense_graph_to_torch

    if linear not in ("auto", "smw", "pcg"):
        raise ValueError(f"unknown linear solver {linear!r}")
    if exact_linear:
        raise NotImplementedError("exact_linear=True (Cholesky path) is not "
                                  "ported yet")
    dev = resolve_device(device)
    graph = dense_graph_to_torch(graph, dev)
    poses0 = torch.as_tensor(poses0, dtype=torch.float32, device=dev)
    F, D = graph.pose_valid.shape
    Lb = graph.loops.valid.shape[0]
    if linear == "pcg" or (linear == "auto" and (4 * Lb > 4096 or F > 4096)):
        raise NotImplementedError("the sparse-loop PCG linear path is not "
                                  "ported yet")

    assemble = functools.partial(
        assemble_blocks, graph, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std)
    A, B, g, U, cost = assemble(poses0)
    # the Woodbury columns sweep in bf16 anyway; carry U in bf16
    U = U.to(torch.bfloat16)
    cost0 = cost

    pk = _auto_pack(F, 4 * D) if pack is None else pack
    solve = functools.partial(
        _smw_solve_core, pack=pk,
        fused_levels=(pk > 1) if fused is None else fused)
    lam = torch.tensor(1e-4, dtype=poses0.dtype, device=dev)
    # the cold Newton-Schulz factor seeds the warm chain (dx discarded)
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
        poses = torch.where(accept, new_poses, poses)
        A = torch.where(accept, An, A)
        B = torch.where(accept, Bn, B)
        g = torch.where(accept, gn, g)
        U = torch.where(accept, Un.to(U.dtype), U)
        converged = accept & (cost - new_cost <= function_tolerance * cost)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-10, 1e10)
        stalled = ~accept & (lam >= 1e9)
        it += 1
        done = bool(converged | stalled)
    return SolveResult(poses=poses, cost=cost, initial_cost=cost0,
                       iterations=it, lam=lam)
