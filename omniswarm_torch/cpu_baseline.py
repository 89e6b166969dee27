"""Measured CPU solver baseline on the bench's headline problem.

Counterpart of ``tools/cpu_baseline.py``: LM on the 5-drone x 100-keyframe
problem of ``omniswarm_torch.bench`` (simulator seed 0, the same residual
models and accept/reject logic as ``solver/dense.py::lm_solve_bt``), timed
on this host's CPU as iterations per second:

1. ``numpy_splu``: vectorised numpy residual and Jacobian assembly and a
   SuperLU factorization of the full sparse Hessian each iteration (the
   Ceres SPARSE_NORMAL_CHOLESKY equivalent);
2. ``numpy_bt_thomas``: the same assembly, a block-tridiagonal Cholesky
   sweep and Sherman-Morrison-Woodbury for the loop columns;
3. ``torch_cpu_bt`` and ``torch_cpu_bt_batch8``: the port's
   ``lm_solve_bt`` and ``lm_solve_bt_batched`` (the bench's eight inits) on
   ``device="cpu"`` (the reference's ``jax_cpu_bt`` rows ran its solver
   compiled by XLA for the CPU).

The numpy solvers are copies of the reference tool's, built from the
port's own graph. ``omniswarm_torch.bench`` reads the JSON this writes, on
the card's own host, for its ``vs_*`` fields.

    python -m omniswarm_torch.cpu_baseline [--iters 100] [--reps 3]
        [--skip-torch-cpu] [--out build/bench/baseline_cpu.json]

``--out`` refuses the repository's pre-port ``BASELINE_MEASURED.json``
(another host's numbers).
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import time
from pathlib import Path

import numpy as np
import torch

from omniswarm_torch.benchutil import (BATCH, batch_inits,
                                       refuse_reference_output)

DEFAULT_OUT = "build/bench/baseline_cpu.json"
REFERENCE_OUTPUTS = ("BASELINE_MEASURED.json",)

HUBER = 1.0
SPHERE_STD = 0.1
INV_DEP_STD = 0.5


def wrap(a):
    return a - 2 * np.pi * np.floor((a + np.pi) / (2 * np.pi))


def huber_rho(sq, delta=HUBER):
    d2 = delta * delta
    return np.where(sq <= d2, sq, 2.0 * delta * np.sqrt(np.maximum(sq, 0.0)) - d2)


class NpGraph:
    """Numpy mirror of solver.dense.DenseGraph (same field meanings), from
    a graph with numpy or CPU tensor leaves."""

    def __init__(self, g):
        for f in g._fields:
            setattr(self, f, None)
        for f in ("range_dist", "range_valid", "range_sqrt_inf", "odom_dpose",
                  "odom_sqrt_info", "odom_valid", "det_dir", "det_tb",
                  "det_invdep", "det_valid", "det_has_depth", "pose_valid",
                  "pose_fixed", "yaw_fixed"):
            setattr(self, f, np.asarray(getattr(g, f), np.float64)
                    if "valid" not in f and "fixed" not in f
                    else np.asarray(getattr(g, f)))
        l = g.loops
        self.l_fa = np.asarray(l.frame_a)
        self.l_da = np.asarray(l.drone_a)
        self.l_fb = np.asarray(l.frame_b)
        self.l_db = np.asarray(l.drone_b)
        self.l_dpose = np.asarray(l.dpose, np.float64)
        self.l_sqrt_info = np.asarray(l.sqrt_info, np.float64)
        self.l_valid = np.asarray(l.valid)


def assemble_np(g: NpGraph, poses: np.ndarray):
    """(A, Boff, grad, loop_terms, cost): frame-block normal equations.

    Same math as solver/dense.py::assemble_blocks, in float64 numpy.
    loop_terms = (ja, jb, rl, na, nb) weighted loop Jacobians for either the
    sparse scatter (splu path) or the Woodbury columns (thomas path).
    """
    F, D = g.pose_valid.shape
    m = 4 * D
    intra = np.zeros((F, D, D, 4, 4))
    diag = np.zeros((F, D, 4, 4))
    gvec = np.zeros((F, D, 4))
    cost = 0.0

    # ranges
    t = poses[..., :3]
    diff = t[:, :, None, :] - t[:, None, :, :]
    dist = np.sqrt(np.sum(diff * diff, -1) + 1e-12)
    si = g.range_sqrt_inf
    r = (dist - g.range_dist) * si
    su = diff / dist[..., None] * (si if np.ndim(si) == 0 else si[..., None])
    w = np.where(np.abs(r) <= HUBER, 1.0, HUBER / np.maximum(np.abs(r), 1e-12))
    w = w * g.range_valid
    cost += 0.5 * np.sum(np.where(g.range_valid, huber_rho(r * r), 0.0))
    wB3 = su[..., :, None] * su[..., None, :] * w[..., None, None]
    wB3_sym = wB3 + np.swapaxes(wB3, 1, 2)
    diag[..., :3, :3] += np.sum(wB3_sym, axis=2)
    intra[..., :3, :3] += -wB3_sym
    gr = su * (w * r)[..., None]
    gvec[..., :3] += np.sum(gr - np.swapaxes(gr, 1, 2), axis=2)

    # detections (bearing + inverse depth)
    if g.det_valid.any():
        ya = poses[..., 3]
        diffb = -diff
        c = np.cos(ya)[:, :, None]
        s = np.sin(ya)[:, :, None]
        relx = c * diffb[..., 0] + s * diffb[..., 1]
        rely = -s * diffb[..., 0] + c * diffb[..., 1]
        rel = np.stack([relx, rely, diffb[..., 2]], -1)
        n = np.sqrt(np.sum(rel * rel, -1) + 1e-12)
        unit = rel / n[..., None]
        err3 = unit - g.det_dir
        res01 = np.einsum("fabkj,fabj->fabk", g.det_tb, err3) / SPHERE_STD
        res2 = (g.det_invdep - 1.0 / n) / INV_DEP_STD * g.det_has_depth
        rd = np.concatenate([res01, res2[..., None]], -1)
        P3 = (np.eye(3) - unit[..., :, None] * unit[..., None, :]) / n[..., None, None]
        dres01 = np.einsum("fabkj,fabji->fabki", g.det_tb, P3) / SPHERE_STD
        dres2 = unit / (n * n)[..., None] / INV_DEP_STD * g.det_has_depth[..., None]
        dres = np.concatenate([dres01, dres2[..., None, :]], -2)
        Rm = np.zeros(rel.shape[:-1] + (3, 3))
        Rm[..., 0, 0] = c
        Rm[..., 0, 1] = s
        Rm[..., 1, 0] = -s
        Rm[..., 1, 1] = c
        Rm[..., 2, 2] = 1.0
        drel_dya = np.stack([rely, -relx, np.zeros_like(relx)], -1)
        J_t_b = np.einsum("fabki,fabij->fabkj", dres, Rm)
        J_yaw_a = np.einsum("fabki,fabi->fabk", dres, drel_dya)
        Ja = np.concatenate([-J_t_b, J_yaw_a[..., None]], -1)
        Jb = np.concatenate([J_t_b, np.zeros_like(J_yaw_a)[..., None]], -1)
        normd = np.linalg.norm(rd, axis=-1)
        wd = np.where(normd <= HUBER, 1.0, HUBER / np.maximum(normd, 1e-12))
        wd = wd * g.det_valid
        cost += 0.5 * np.sum(np.where(g.det_valid, huber_rho(normd * normd), 0.0))
        wJa = Ja * wd[..., None, None]
        wJb = Jb * wd[..., None, None]
        diag += np.sum(np.einsum("fabki,fabkj->fabij", wJa, Ja), axis=2)
        diag += np.sum(np.einsum("fabki,fabkj->fabij", wJb, Jb), axis=1)
        Bab = np.einsum("fabki,fabkj->fabij", wJa, Jb)
        intra += Bab
        intra += np.swapaxes(np.swapaxes(Bab, -1, -2), 1, 2)
        gvec += np.sum(np.einsum("fabki,fabk->fabi", wJa, rd), axis=2)
        gvec += np.sum(np.einsum("fabki,fabk->fabi", wJb, rd), axis=1)

    # odometry
    pa, pb = poses[:-1], poses[1:]
    co = np.cos(pa[..., 3])
    so = np.sin(pa[..., 3])
    dxw = pb[..., 0] - pa[..., 0]
    dyw = pb[..., 1] - pa[..., 1]
    dx_ = co * dxw + so * dyw
    dy_ = -so * dxw + co * dyw
    dz_ = pb[..., 2] - pa[..., 2]
    dyaw = wrap(pb[..., 3] - pa[..., 3])
    om = g.odom_dpose
    e = np.stack([om[..., 0] - dx_, om[..., 1] - dy_, om[..., 2] - dz_,
                  wrap(om[..., 3] - dyaw)], -1)
    sI = g.odom_sqrt_info
    ro = sI * e
    ov = g.odom_valid
    cost += 0.5 * np.sum(np.where(ov, np.sum(ro * ro, -1), 0.0))
    zo = np.zeros_like(co)
    one = np.ones_like(co)
    Ja_o = np.stack([
        np.stack([co, so, zo, -dy_], -1),
        np.stack([-so, co, zo, dx_], -1),
        np.stack([zo, zo, one, zo], -1),
        np.stack([zo, zo, zo, one], -1)], -2) * sI[..., :, None]
    Jb_o = np.stack([
        np.stack([-co, -so, zo, zo], -1),
        np.stack([so, -co, zo, zo], -1),
        np.stack([zo, zo, -one, zo], -1),
        np.stack([zo, zo, zo, -one], -1)], -2) * sI[..., :, None]
    ovf = ov.astype(np.float64)
    wJa_o = Ja_o * ovf[..., None, None]
    wJb_o = Jb_o * ovf[..., None, None]
    Baa_o = np.einsum("fdki,fdkj->fdij", wJa_o, Ja_o)
    Bbb_o = np.einsum("fdki,fdkj->fdij", wJb_o, Jb_o)
    Bab_o = np.einsum("fdki,fdkj->fdij", wJa_o, Jb_o)
    diag[:-1] += Baa_o
    diag[1:] += Bbb_o
    gvec[:-1] += np.einsum("fdki,fdk->fdi", wJa_o, ro)
    gvec[1:] += np.einsum("fdki,fdk->fdi", wJb_o, ro)

    # loops: weighted Jacobians (scatter deferred to the linear solver)
    N = F * D
    pflat = poses.reshape(N, 4)
    la = pflat[g.l_fa * D + g.l_da]
    lb = pflat[g.l_fb * D + g.l_db]
    co = np.cos(la[:, 3])
    so = np.sin(la[:, 3])
    dxw = lb[:, 0] - la[:, 0]
    dyw = lb[:, 1] - la[:, 1]
    dx_ = co * dxw + so * dyw
    dy_ = -so * dxw + co * dyw
    dz_ = lb[:, 2] - la[:, 2]
    dyaw = wrap(lb[:, 3] - la[:, 3])
    e = g.l_dpose - np.stack([dx_, dy_, dz_, dyaw], -1)
    e[:, 3] = wrap(e[:, 3])
    rl = np.einsum("kij,kj->ki", g.l_sqrt_info, e)
    zo = np.zeros_like(co)
    one = np.ones_like(co)
    Ua = np.stack([
        np.stack([co, so, zo, -dy_], -1),
        np.stack([-so, co, zo, dx_], -1),
        np.stack([zo, zo, one, zo], -1),
        np.stack([zo, zo, zo, one], -1)], -2)
    Ub = np.stack([
        np.stack([-co, -so, zo, zo], -1),
        np.stack([so, -co, zo, zo], -1),
        np.stack([zo, zo, -one, zo], -1),
        np.stack([zo, zo, zo, -one], -1)], -2)
    ja = np.einsum("kij,kjl->kil", g.l_sqrt_info, Ua)
    jb = np.einsum("kij,kjl->kil", g.l_sqrt_info, Ub)
    sq = np.sum(rl * rl, -1)
    wl = np.where(sq <= HUBER * HUBER, 1.0,
                  HUBER / np.maximum(np.sqrt(sq), 1e-12))
    cost += 0.5 * np.sum(np.where(g.l_valid, huber_rho(sq), 0.0))
    ws = np.sqrt(wl) * g.l_valid
    ja = ja * ws[:, None, None]
    jb = jb * ws[:, None, None]
    rlw = rl * ws[:, None]
    na = g.l_fa * D + g.l_da
    nb = g.l_fb * D + g.l_db
    gflat = gvec.reshape(N, 4)
    np.add.at(gflat, na, np.einsum("kmi,km->ki", ja, rlw))
    np.add.at(gflat, nb, np.einsum("kmi,km->ki", jb, rlw))

    # frame blocks
    ii = np.arange(D)
    intra[:, ii, ii] += diag
    A = intra.transpose(0, 1, 3, 2, 4).reshape(F, m, m)
    Boff = np.zeros((F - 1, D, 4, D, 4))
    Boff[:, ii, :, ii, :] = Bab_o.transpose(1, 0, 2, 3)
    Boff = Boff.reshape(F - 1, m, m)

    # parameter mask
    free = g.pose_valid & ~g.pose_fixed
    mask4 = np.repeat(free[..., None], 4, -1)
    mask4[..., 3] &= ~g.yaw_fixed
    mflat = mask4.reshape(F, m).astype(np.float64)
    A = A * mflat[:, :, None] * mflat[:, None, :]
    A += np.eye(m)[None] * ((1.0 - mflat)[:, :, None] * np.eye(m)[None])
    Boff = Boff * mflat[:-1, :, None] * mflat[1:, None, :]
    gm = gflat.reshape(F, m) * mflat

    # per-entry parameter mask for loop jacobian columns
    ja = ja * mflat.reshape(N, 4)[na][:, None, :]
    jb = jb * mflat.reshape(N, 4)[nb][:, None, :]
    return A, Boff, gm, (ja, jb, rlw, na, nb), cost


def _H_pattern(F, D, na, nb):
    """Constant COO pattern of the full Hessian (Ceres' symbolic analysis)."""
    m = 4 * D
    rows, cols = [], []
    fi = (np.arange(F)[:, None, None] * m + np.arange(m)[None, :, None])
    fj = (np.arange(F)[:, None, None] * m + np.arange(m)[None, None, :])
    shA = (F, m, m)
    rows.append(np.broadcast_to(fi, shA).ravel())
    cols.append(np.broadcast_to(fj, shA).ravel())
    shB = (F - 1, m, m)
    oi = (np.arange(F - 1)[:, None, None] * m + np.arange(m)[None, :, None])
    oj = ((np.arange(F - 1)[:, None, None] + 1) * m
          + np.arange(m)[None, None, :])
    rows += [np.broadcast_to(oi, shB).ravel(), np.broadcast_to(oj, shB).ravel()]
    cols += [np.broadcast_to(oj, shB).ravel(), np.broadcast_to(oi, shB).ravel()]
    i4 = np.arange(4)
    L = len(na)
    shL = (L, 4, 4)
    for (nn, mm2) in ((na, na), (nb, nb), (na, nb), (nb, na)):
        ri = nn[:, None, None] * 4 + i4[None, :, None]
        ci = mm2[:, None, None] * 4 + i4[None, None, :]
        rows.append(np.broadcast_to(ri, shL).ravel())
        cols.append(np.broadcast_to(ci, shL).ravel())
    return np.concatenate(rows), np.concatenate(cols)


def _H_vals(A, Boff, loop_terms):
    ja, jb, _, na, nb = loop_terms
    Haa = np.einsum("kmi,kmj->kij", ja, ja)
    Hbb = np.einsum("kmi,kmj->kij", jb, jb)
    Hab = np.einsum("kmi,kmj->kij", ja, jb)
    return np.concatenate([
        A.ravel(), Boff.ravel(), np.swapaxes(Boff, -1, -2).ravel(),
        Haa.ravel(), Hbb.ravel(), Hab.ravel(),
        np.swapaxes(Hab, -1, -2).ravel()])


def build_sparse_H(A, Boff, loop_terms, F, D, pattern=None):
    import scipy.sparse as sp
    m = A.shape[1]
    P = F * m
    if pattern is None:
        pattern = _H_pattern(F, D, loop_terms[3], loop_terms[4])
    return sp.coo_matrix((_H_vals(A, Boff, loop_terms), pattern),
                         shape=(P, P)).tocsc()


def lm_solve_splu(g: NpGraph, poses0, max_iterations, ftol=0.0):
    """LM with scipy SuperLU on the sparse Hessian (Ceres-equivalent)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    F, D = g.pose_valid.shape
    poses = poses0.copy()
    A, Boff, gm, lt, cost = assemble_np(g, poses)
    pattern = _H_pattern(F, D, lt[3], lt[4])
    H = build_sparse_H(A, Boff, lt, F, D, pattern)
    gv = gm.reshape(-1)
    # (gradient from loops already folded into gm inside assemble_np)
    lam, it = 1e-4, 0
    P = H.shape[0]
    while it < max_iterations:
        dvec = np.maximum(H.diagonal(), 1e-6)
        Hd = H + sp.diags(lam * dvec, format="csc")
        try:
            dx = spl.splu(Hd, permc_spec="MMD_AT_PLUS_A",
                          options=dict(SymmetricMode=True)).solve(-gv)
        except RuntimeError:
            dx = np.full(P, np.nan)
        bad = not np.all(np.isfinite(dx))
        newp = poses + (0 if bad else dx.reshape(F, D, 4))
        newp[..., 3] = wrap(newp[..., 3])
        An, Bn, gn, ltn, new_cost = assemble_np(g, newp)
        accept = np.isfinite(new_cost) and (new_cost < cost) and not bad
        conv = accept and (cost - new_cost <= ftol * cost)
        if accept:
            poses, cost = newp, new_cost
            H = build_sparse_H(An, Bn, ltn, F, D, pattern)
            gv = gn.reshape(-1)
        lam = min(max(lam * (0.3 if accept else 5.0), 1e-10), 1e10)
        it += 1
        if conv or ((not accept) and lam >= 1e9):
            break
    return poses, cost, it


def lm_solve_thomas(g: NpGraph, poses0, max_iterations, ftol=0.0):
    """LM with block-tridiagonal Cholesky + Woodbury (structure-aware CPU)."""
    import scipy.linalg as sl
    F, D = g.pose_valid.shape
    m = 4 * D

    def bt_chol_solve(A, Boff, rhs, lam):
        # damped diagonal (include loop columns' diag like the TPU path)
        dT = np.einsum("fii->fi", A)
        d = lam * np.maximum(dT + dUdiag, 1e-6)
        # forward block elimination (Thomas with per-block Cholesky)
        X = rhs.copy()
        Scs = []
        Sc = A[0] + np.diag(d[0])
        for f in range(F):
            cf = sl.cho_factor(Sc, lower=True, check_finite=False)
            Scs.append(cf)
            X[f] = sl.cho_solve(cf, X[f], check_finite=False)
            if f < F - 1:
                X[f + 1] = rhs[f + 1] - Boff[f].T @ X[f]
                W = sl.cho_solve(cf, Boff[f], check_finite=False)
                Sc = A[f + 1] + np.diag(d[f + 1]) - Boff[f].T @ W
        # back substitution
        Y = X.copy()
        for f in range(F - 2, -1, -1):
            Y[f] = X[f] - sl.cho_solve(
                Scs[f], Boff[f] @ Y[f + 1], check_finite=False)
        return Y

    def smw(A, Boff, gm, lt, lam):
        ja, jb, _, na, nb = lt
        L = ja.shape[0]
        C = 4 * L
        U = np.zeros((F * m, C))
        colk = np.arange(L)[:, None, None] * 4 + np.arange(4)[None, :, None]
        rowa = na[:, None, None] * 4 + np.arange(4)[None, None, :]
        rowb = nb[:, None, None] * 4 + np.arange(4)[None, None, :]
        np.add.at(U, (np.broadcast_to(rowa, (L, 4, 4)).ravel(),
                      np.broadcast_to(colk, (L, 4, 4)).ravel()), ja.ravel())
        np.add.at(U, (np.broadcast_to(rowb, (L, 4, 4)).ravel(),
                      np.broadcast_to(colk, (L, 4, 4)).ravel()), jb.ravel())
        Uf = U.reshape(F, m, C)
        rhs = np.concatenate([-gm[..., None], Uf], -1)
        Y = bt_chol_solve(A, Boff, rhs, lam)
        yb = Y[..., 0]
        YU = Y[..., 1:]
        S = np.eye(C) + np.einsum("fmc,fmd->cd", Uf, YU)
        Uyb = np.einsum("fmc,fm->c", Uf, yb)
        z = np.linalg.solve(S, Uyb)
        dx = yb - np.einsum("fmc,c->fm", YU, z)
        return dx.reshape(-1)

    poses = poses0.copy()
    A, Boff, gm, lt, cost = assemble_np(g, poses)
    dUdiag = np.zeros((F, m))

    def upd_dU(lt):
        ja, jb, _, na, nb = lt
        dU = np.zeros((F * m, ))
        np.add.at(dU, (na[:, None] * 4 + np.arange(4)[None, :]).ravel(),
                  np.einsum("kmi,kmi->ki", ja, ja).ravel())
        np.add.at(dU, (nb[:, None] * 4 + np.arange(4)[None, :]).ravel(),
                  np.einsum("kmi,kmi->ki", jb, jb).ravel())
        return dU.reshape(F, m)

    dUdiag = upd_dU(lt)
    lam, it = 1e-4, 0
    while it < max_iterations:
        dx = smw(A, Boff, gm, lt, lam)
        bad = not np.all(np.isfinite(dx))
        newp = poses + (0 if bad else dx.reshape(F, D, 4))
        newp[..., 3] = wrap(newp[..., 3])
        An, Bn, gn, ltn, new_cost = assemble_np(g, newp)
        accept = np.isfinite(new_cost) and (new_cost < cost) and not bad
        conv = accept and (cost - new_cost <= ftol * cost)
        if accept:
            poses, cost = newp, new_cost
            A, Boff, gm, lt = An, Bn, gn, ltn
            dUdiag = upd_dU(lt)
        lam = min(max(lam * (0.3 if accept else 5.0), 1e-10), 1e10)
        it += 1
        if conv or ((not accept) and lam >= 1e9):
            break
    return poses, cost, it


def bench_problem():
    """(graph, VIO init) of the bench's headline problem: 5 x 100, seed 0."""
    from omniswarm_torch import sim
    from omniswarm_torch.solver.dense import dense_graph_from_sim

    data = sim.generate(sim.SimParams(num_drones=5, num_frames=100, seed=0))
    return dense_graph_from_sim(data), np.asarray(data.vio, np.float64)


def _timed(fn, reps: int, warm_up: bool = True):
    """(last result, median wall seconds over reps), after a warm-up call
    unless ``warm_up`` is False."""
    out = fn() if warm_up else None
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def measure(iters: int = 100, reps: int = 3, torch_cpu: bool = True,
            problem=None, warm_up: bool = True) -> dict:
    """The baseline's JSON object (``problem``: (graph, init), default the
    bench's headline problem). ``warm_up`` False (``chip_smoke.py``'s)
    times each row's first call, but for ``torch_cpu_bt``: the process's
    first torch solve on the CPU pays a one-time set-up (9.89 against
    27.45 iter/s warm, on the 8-core host of an H100 machine), and that
    warm-up also warms the batch."""
    from omniswarm_torch.solver.dense import lm_solve_bt, lm_solve_bt_batched

    graph, init = problem or bench_problem()
    g = NpGraph(graph)
    out = {"host": platform.processor() or platform.machine(),
           "nproc": os.cpu_count(), "torch_threads": torch.get_num_threads(),
           "problem": "5drone_100kf_seed0", "iters_requested": iters}
    for name, fn in (("numpy_splu", lm_solve_splu),
                     ("numpy_bt_thomas", lm_solve_thomas)):
        (_, cost, it), dt = _timed(lambda: fn(g, init, iters), reps,
                                   warm_up)
        out[name] = {"iter_per_s": round(it / dt, 2), "iters": int(it),
                     "final_cost": float(cost), "wall_s": round(dt, 3)}
        print(name, out[name], flush=True)
    if torch_cpu:
        x0 = np.asarray(init, np.float32)
        kw = dict(device="cpu", max_iterations=iters, function_tolerance=0.0)
        r, dt = _timed(lambda: lm_solve_bt(graph, x0, **kw), reps)
        out["torch_cpu_bt"] = {"iter_per_s": round(r.iterations / dt, 2),
                               "iters": r.iterations,
                               "final_cost": float(r.cost)}
        print("torch_cpu_bt", out["torch_cpu_bt"], flush=True)
        xs = batch_inits(x0)
        r, dt = _timed(lambda: lm_solve_bt_batched(graph, xs, **kw),
                       max(1, reps - 1), warm_up)
        out["torch_cpu_bt_batch8"] = {
            "aggregate_iter_per_s": round(BATCH * r.iterations / dt, 2),
            "iters": r.iterations, "final_cost0": float(r.cost[0])}
        print("torch_cpu_bt_batch8", out["torch_cpu_bt_batch8"], flush=True)
    best = max(v["iter_per_s"] for v in out.values()
               if isinstance(v, dict) and "iter_per_s" in v)
    out["best_cpu_iter_per_s"] = best
    agg = out.get("torch_cpu_bt_batch8", {}).get("aggregate_iter_per_s", 0.0)
    out["best_cpu_aggregate_iter_per_s"] = max(best, agg)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m omniswarm_torch.cpu_baseline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--skip-torch-cpu", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    out = measure(args.iters, args.reps, not args.skip_torch_cpu)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"best_cpu_iter_per_s": out["best_cpu_iter_per_s"],
                      "out": args.out}), flush=True)
    return out


if __name__ == "__main__":
    main()
