"""Sliding-window LM with the FRAME axis split over ranks.

Counterpart of ``omniswarm_tpu/parallel/sharded_window.py``. The (F, D, 4)
poses, the (F, m, m) block-tridiagonal normal equations and the rows of the
Woodbury loop columns are split along frames; each rank assembles and
solves its frames, and the couplings are

- a one-frame halo: the next rank's first poses and masks come in ONE
  ``recv_from_next`` of the packed ``[pose | valid | fixed | yaw_fixed]``,
  and the halo frame's diagonal block, gradient and this rank's boundary
  coupling go out in ONE ``send_next`` of ``[A_halo | g_halo | B_right]``;
- one ``all_gather`` of the poses for the loop endpoints;
- the SPIKE solve of ``bt_spike`` (one ``all_gather`` of the spike tips);
- ONE ``psum`` of the packed ``[S | U^T y_b]``: the (C, C) Woodbury
  capacitance and its right-hand side, solved replicated;
- ONE ``psum`` of ``[cost | bad]``: the candidate's cost and the step's
  failure flag (the reference's ``pmax`` of ``bad``), so that every
  accept, λ and stop decision reads a reduced value and all ranks take the
  same branch and call the same collectives in the same order.

Algebraic contract: the normal equations and the LM trajectory of
``solver.dense.lm_solve_bt`` with the exact linear path, up to float
summation order. The loop columns' scatter is ``index_put_(accumulate=
True)`` into a dump row (sort-based, deterministic) and their gradient the
product ``U @ r``; assembly and solves run in true f32 (``highp``).
"""
from __future__ import annotations

import functools

import torch

from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.core.precision import highp
from omniswarm_torch.parallel.bt_spike import solve_or_nan, spike_local_solve
from omniswarm_torch.solver import factors as fx
from omniswarm_torch.solver.dense import (DenseGraph, _relpose_terms_analytic,
                                          assemble_blocks)
from omniswarm_torch.solver.gauss_newton import (SolveResult, _apply_step,
                                                 poses_to_device)
from omniswarm_torch.solver.graph import empty_relpose

# the frame-indexed fields of a DenseGraph (odometry rows included once
# padded to F rows); the loops, the scalar range weight and the antenna
# offsets are replicated
FRAME_FIELDS = ("range_dist", "range_valid", "odom_dpose", "odom_sqrt_info",
                "odom_valid", "det_dir", "det_tb", "det_invdep", "det_valid",
                "det_has_depth", "pose_valid", "pose_fixed", "yaw_fixed")


def _frame_fields(graph: DenseGraph):
    return FRAME_FIELDS + (("range_sqrt_inf",)
                           if graph.range_sqrt_inf.ndim else ())


def pad_graph_frames(graph: DenseGraph, poses0: torch.Tensor,
                     n_devices: int):
    """The frame axis padded to a multiple of ``n_devices``: pad frames are
    invalid with no measurements, and the odometry rows go from F-1 to the
    new F (row f couples f and f+1; padded rows invalid). Returns (graph,
    poses, F_orig)."""
    F = graph.pose_valid.shape[0]
    Fp = -(-F // n_devices) * n_devices

    def pad(x):
        need = Fp - x.shape[0]
        return x if need <= 0 else torch.cat(
            [x, x.new_zeros((need,) + x.shape[1:])], 0)

    g = graph._replace(**{k: pad(getattr(graph, k))
                          for k in _frame_fields(graph)})
    return g, pad(poses0), F


def frame_rows(graph: DenseGraph, poses: torch.Tensor, axis):
    """This rank's frame rows of a padded graph and its poses (the
    reference's ``_graph_specs``)."""
    Fs = graph.pose_valid.shape[0] // axis.size
    rows = slice(axis.index * Fs, (axis.index + 1) * Fs)
    g = graph._replace(**{k: getattr(graph, k)[rows]
                          for k in _frame_fields(graph)})
    return g, poses[rows]


@highp()
def _assemble_sharded(g: DenseGraph, poses_loc: torch.Tensor, axis, *,
                      huber_delta: float, det_sphere_std: float,
                      det_inv_dep_std: float):
    """This rank's normal equations with a one-frame halo.

    ``g`` holds the rank's frame rows (odometry row f couples local frames
    f, f+1; the last row straddles into the next rank). The block assembly
    runs on Fs + 1 frames: the halo frame collects the straddling odometry
    factor's diagonal and gradient, which go to their owner.

    Returns (A (Fs, m, m), Bfull (Fs, m, m) whose last row couples to the
    next rank, g (Fs, m), U (Fs, m, 4L), cost_part, B_left): the psum of
    cost_part is the global cost, B_left the previous rank's coupling.
    """
    P, p = axis.size, axis.index
    Fs, D = g.pose_valid.shape
    m = 4 * D
    dtype, dev = poses_loc.dtype, poses_loc.device

    # ONE halo exchange for the pose and its three masks
    packed = torch.cat([poses_loc, g.pose_valid[..., None].to(dtype),
                        g.pose_fixed[..., None].to(dtype),
                        g.yaw_fixed[..., None].to(dtype)], -1)  # (Fs, D, 7)
    halo = axis.recv_from_next(packed[0])                      # (D, 7)
    halo_valid = halo[..., 4] > 0.5
    if p == P - 1:                                  # rank 0's row wrapped
        halo_valid = torch.zeros_like(halo_valid)

    def with_halo(x, fill=0):
        return torch.cat([x, torch.full_like(x[:1], fill)], 0)

    si = g.range_sqrt_inf
    g_loc = g._replace(
        range_dist=with_halo(g.range_dist),
        range_valid=with_halo(g.range_valid, False),
        range_sqrt_inf=with_halo(si) if si.ndim else si,
        det_dir=with_halo(g.det_dir), det_tb=with_halo(g.det_tb),
        det_invdep=with_halo(g.det_invdep),
        det_valid=with_halo(g.det_valid, False),
        det_has_depth=with_halo(g.det_has_depth, False),
        loops=empty_relpose(1, dtype, dev),         # loops handled below
        pose_valid=torch.cat([g.pose_valid, halo_valid[None]], 0),
        pose_fixed=torch.cat([g.pose_fixed, halo[None, :, 5] > 0.5], 0),
        yaw_fixed=torch.cat([g.yaw_fixed, halo[None, :, 6] > 0.5], 0))
    poses_ext = torch.cat([poses_loc, halo[None, :, :4]], 0)
    A_l, Bfull, g_l, _, cost = assemble_blocks(
        g_loc, poses_ext, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std)

    # the halo row to its owner, with the coupling block the next rank's
    # SPIKE solve needs (its B_left), in ONE exchange
    recv = axis.send_next(torch.cat([A_l[Fs], g_l[Fs][:, None], Bfull[-1]],
                                    -1))                       # (m, 2m+1)
    if p == 0:                                  # the last rank's row wrapped
        recv = torch.zeros_like(recv)
    A_p = torch.cat([A_l[:1] + recv[:, :m], A_l[1:Fs]], 0)
    g_p = torch.cat([g_l[:1] + recv[None, :, m], g_l[1:Fs]], 0)
    B_left = recv[:, m + 1:]

    # loop closures: replicated terms, the rank's rows of U
    lp = g.loops
    L = lp.valid.shape[0]
    pflat = axis.all_gather(poses_loc).reshape(-1, 4)
    r_l, Ja_l, Jb_l = _relpose_terms_analytic(
        pflat[lp.frame_a * D + lp.drone_a], pflat[lp.frame_b * D + lp.drone_b],
        lp.dpose, lp.sqrt_info)
    if p == 0:
        cost = cost + 0.5 * torch.sum(torch.where(
            lp.valid, fx.huber_rho(torch.sum(r_l * r_l, -1), huber_delta),
            0.0))
    ws = torch.sqrt(fx.huber_weight(r_l, huber_delta)) * lp.valid.to(dtype)
    ar4 = torch.arange(4, device=dev)
    col = (torch.arange(L, device=dev)[:, None, None] * 4
           + ar4[None, :, None]).expand(L, 4, 4)        # (L, 4c, 4i)
    U = torch.zeros((Fs * m + 1, 4 * L), dtype=dtype, device=dev)
    for frame, drone, J in ((lp.frame_a, lp.drone_a, Ja_l),
                            (lp.frame_b, lp.drone_b, Jb_l)):
        own = (frame >= p * Fs) & (frame < (p + 1) * Fs)
        row = (frame - p * Fs)[:, None] * m + drone[:, None] * 4 + ar4
        row = torch.where(own[:, None], row, Fs * m)    # the dump row
        U.index_put_((row[:, None, :].expand(L, 4, 4).reshape(-1),
                      col.reshape(-1)),
                     (J * ws[:, None, None]).reshape(-1), accumulate=True)
    U = U[:-1]
    # the loops' gradient J^T r as one product (a fixed summation order)
    gflat = g_p + (U @ (r_l * ws[:, None]).reshape(4 * L)).reshape(Fs, m)

    # the free-parameter mask again: the halo add and the loop rows
    free = g.pose_valid & ~g.pose_fixed
    mflat = torch.cat([free[..., None].expand(Fs, D, 3),
                       (free & ~g.yaw_fixed)[..., None]], -1
                      ).reshape(Fs, m).to(dtype)
    eye = torch.eye(m, dtype=dtype, device=dev)
    A_p = A_p * mflat[:, :, None] * mflat[:, None, :] \
        + eye * (1.0 - mflat)[:, :, None]
    U = U.reshape(Fs, m, 4 * L) * mflat[:, :, None]
    return A_p, Bfull, gflat * mflat, U, cost, B_left


@highp()
def _smw_spike(A, Bfull, gflat, U, lam, axis, *, direct_threshold: int = 8,
               B_left=None) -> torch.Tensor:
    """Damped (T + U U^T) dx = -g with the frames split: the rank's rows of
    the block-tridiagonal solve by SPIKE, the (C, C) capacitance and
    U^T y_b summed in ONE psum and solved replicated. Returns the rank's
    flat dx (Fs*m,)."""
    Fs, m = A.shape[0], A.shape[1]
    C = U.shape[-1]
    d = lam * torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1)
                              + torch.sum(U * U, -1), 1e-6)
    Ad = A + d[..., None] * torch.eye(m, dtype=A.dtype, device=A.device)
    Y = spike_local_solve(Ad, Bfull, torch.cat([-gflat[..., None], U], -1),
                          axis, direct_threshold=direct_threshold,
                          B_left=B_left)
    yb = Y[..., 0].reshape(Fs * m)
    YU = Y[..., 1:].reshape(Fs * m, C)
    Uf = U.reshape(Fs * m, C)
    red = axis.psum(torch.cat([(Uf.mT @ YU).reshape(-1), Uf.mT @ yb]))
    S = torch.eye(C, dtype=A.dtype, device=A.device) \
        + red[:C * C].reshape(C, C)
    z = solve_or_nan(S, red[C * C:, None])[:, 0]                # replicated
    return yb - YU @ z


@highp()
def _lm_sharded(g: DenseGraph, poses0: torch.Tensor, axis, *,
                max_iterations: int, huber_delta: float,
                det_sphere_std: float, det_inv_dep_std: float,
                function_tolerance: float, direct_threshold: int):
    """The LM loop on one rank's frames; returns (poses_loc, cost, cost0,
    iterations, lam), the scalars replicated."""
    assemble = functools.partial(
        _assemble_sharded, g, axis=axis, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std)
    A, B, gf, U, cost_p, Bl = assemble(poses0)
    cost = axis.psum(cost_p)
    cost0 = cost
    poses = poses0
    lam = torch.tensor(1e-4, dtype=poses0.dtype, device=poses0.device)
    it = 0
    done = False
    while not done and it < max_iterations:
        dx = _smw_spike(A, B, gf, U, lam, axis,
                        direct_threshold=direct_threshold, B_left=Bl)
        bad = ~torch.all(torch.isfinite(dx))
        new_poses = _apply_step(poses, torch.where(bad, 0.0, dx))
        An, Bn, gn, Un, cost_p, Bln = assemble(new_poses)
        red = axis.psum(torch.stack([cost_p, bad.to(cost_p.dtype)]))
        new_cost, bad = red[0], red[1] > 0            # replicated
        accept = torch.isfinite(new_cost) & (new_cost < cost) & ~bad
        poses, A, B, gf, U, Bl = (
            torch.where(accept, n, o) for n, o in zip(
                (new_poses, An, Bn, gn, Un, Bln), (poses, A, B, gf, U, Bl)))
        converged = accept & (cost - new_cost <= function_tolerance * cost)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-10, 1e10)
        stalled = ~accept & (lam >= 1e9)
        it += 1
        done = bool(converged | stalled)
    return poses, cost, cost0, it, lam


def _rank_problem(graph, poses0, axis):
    """The whole problem on ``axis.device``, frames padded to the world:
    (this rank's graph rows, its poses, F_orig)."""
    graph = dense_graph_to_torch(graph, axis.device)
    poses0 = poses_to_device(poses0, axis.device)
    graph, poses0, F = pad_graph_frames(graph, poses0, axis.size)
    g, p0 = frame_rows(graph, poses0, axis)
    return g, p0, F


def sharded_normal_equations(graph: DenseGraph, poses, axis, *,
                             huber_delta: float = 1.0,
                             det_sphere_std: float = 0.1,
                             det_inv_dep_std: float = 0.5):
    """This rank's (A, Bfull, g, U, cost_part, B_left) at ``poses`` from
    the whole problem, as the sharded LM assembles them."""
    g, p0, _ = _rank_problem(graph, poses, axis)
    return _assemble_sharded(g, p0, axis, huber_delta=huber_delta,
                             det_sphere_std=det_sphere_std,
                             det_inv_dep_std=det_inv_dep_std)


def lm_solve_bt_sharded(graph: DenseGraph, poses0, axis, *,
                        max_iterations: int = 100, huber_delta: float = 1.0,
                        det_sphere_std: float = 0.1,
                        det_inv_dep_std: float = 0.5,
                        function_tolerance: float = 1e-6,
                        direct_threshold: int = 8) -> SolveResult:
    """Frame-sharded sliding-window LM over ``axis``: the contract of
    ``solver.dense.lm_solve_bt(exact_linear=True)``. Every rank is handed
    the whole problem (numpy or tensor leaves), pads the frames to a
    multiple of the world, solves its rows on ``axis.device`` and returns
    the whole result: poses (F, D, 4) gathered, the scalars replicated."""
    g, p0, F = _rank_problem(graph, poses0, axis)
    poses, cost, cost0, it, lam = _lm_sharded(
        g, p0, axis, max_iterations=max_iterations, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std,
        function_tolerance=function_tolerance,
        direct_threshold=direct_threshold)
    poses = axis.all_gather(poses, label="output").reshape(
        (-1,) + poses.shape[1:])
    return SolveResult(poses=poses[:F], cost=cost, initial_cost=cost0,
                       iterations=it, lam=lam)
