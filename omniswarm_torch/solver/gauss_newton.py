"""Levenberg-Marquardt over the masked generic factor graph.

Counterpart of ``omniswarm_tpu/solver/gauss_newton.py``:

1. every factor family evaluates residuals and (dim, 4) pose Jacobians by
   autodiff (``solver/factors.py``);
2. Huber IRLS sqrt-weights robustify ranges, loops and detections;
3. the 4x4 blocks are scatter-added into a dense (N*N, 16) block Hessian;
4. gauge, validity and yaw masks zero rows and columns (unit diagonal);
5. the damped system is solved by a dense Cholesky (``cholesky_ex``: a
   matrix that is not positive definite gives a rejected step, no raise);
6. the accept/reject loop runs on the host, reading its done flag once per
   iteration.

With ``axis`` (a ``parallel.collectives.Axis``; the reference's
``axis_name``) the graph holds one rank's factor shard and the pose masks
whole: each rank assembles its factors, H, g and the cost are summed over
the ranks in ONE all-reduce of the packed ``[H | g | cost | bad]``, and the
damped solve runs replicated. ``bad`` is the rank's previous step failure,
reduced with the equations so that a failure on any rank gives every rank
a NaN cost: every decision of the loop then reads a reduced value.

Cost convention as in Ceres: 0.5 * sum(rho(||r_block||^2)). The scatter-adds
are ``index_put_(accumulate=True)``, which is sort-based on CUDA, so the
sums over a shared node have the same order in every run.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from omniswarm_torch.core import geometry as geo
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver import factors as fx
from omniswarm_torch.solver.graph import FactorGraph


class SolveResult(NamedTuple):
    poses: torch.Tensor         # (F, D, 4) or (B, F, D, 4)
    cost: torch.Tensor          # () or (B,) final cost (Ceres convention)
    initial_cost: torch.Tensor  # () or (B,)
    iterations: int             # accepted + rejected LM iterations
    lam: torch.Tensor           # () or (B,) final damping


def _family_terms(graph: FactorGraph, poses: torch.Tensor, huber_delta: float,
                  det_sphere_std: float, det_inv_dep_std: float):
    """Residuals, Jacobians and weights of every factor family.

    Returns a list of (node_a, node_b, FactorEval, sqrt_weight, valid) and
    the total robustified cost.
    """
    D = graph.num_drones
    out = []

    def robust_cost(ev, valid):
        return 0.5 * torch.sum(torch.where(
            valid, fx.huber_rho(torch.sum(ev.residual ** 2, -1),
                                huber_delta), 0.0))

    r = graph.ranges
    pa, pb = poses[r.frame, r.drone_a], poses[r.frame, r.drone_b]
    if graph.ant_pos is not None:
        ev = fx.range_eval_antenna(pa, pb, r.dist, r.sqrt_inf,
                                   graph.ant_pos[r.drone_a],
                                   graph.ant_pos[r.drone_b])
    else:
        ev = fx.range_eval(pa, pb, r.dist, r.sqrt_inf)
    cost = robust_cost(ev, r.valid)
    out.append((r.frame * D + r.drone_a, r.frame * D + r.drone_b, ev,
                fx.huber_weight(ev.residual, huber_delta), r.valid))

    # ego-motion chains carry no robust loss
    o = graph.odoms
    ev = fx.relpose_eval(poses[o.frame_a, o.drone_a],
                         poses[o.frame_b, o.drone_b], o.dpose, o.sqrt_info)
    cost = cost + 0.5 * torch.sum(
        torch.where(o.valid, torch.sum(ev.residual ** 2, -1), 0.0))
    out.append((o.frame_a * D + o.drone_a, o.frame_b * D + o.drone_b, ev,
                torch.ones_like(ev.residual[:, 0]), o.valid))

    lp = graph.loops
    ev = fx.relpose_eval(poses[lp.frame_a, lp.drone_a],
                         poses[lp.frame_b, lp.drone_b], lp.dpose,
                         lp.sqrt_info)
    cost = cost + robust_cost(ev, lp.valid)
    out.append((lp.frame_a * D + lp.drone_a, lp.frame_b * D + lp.drone_b, ev,
                fx.huber_weight(ev.residual, huber_delta), lp.valid))

    d = graph.dets
    det_eval = fx.make_detection_eval(det_sphere_std, det_inv_dep_std)
    ev = det_eval(poses[d.frame_a, d.drone_a], poses[d.frame_b, d.drone_b],
                  d.direction, d.tangent_base, d.inv_dep, d.dpose_a,
                  d.dpose_b, d.enable_depth)
    cost = cost + robust_cost(ev, d.valid)
    out.append((d.frame_a * D + d.drone_a, d.frame_b * D + d.drone_b, ev,
                fx.huber_weight(ev.residual, huber_delta), d.valid))
    return out, cost


@highp()
def total_cost(graph: FactorGraph, poses: torch.Tensor, *,
               huber_delta: float = 1.0, det_sphere_std: float = 0.1,
               det_inv_dep_std: float = 0.5, axis=None) -> torch.Tensor:
    """Robustified total cost at the given poses (Ceres convention); with
    ``axis``, the rank's partial cost summed over the ranks."""
    _, cost = _family_terms(graph, poses, huber_delta, det_sphere_std,
                            det_inv_dep_std)
    return cost if axis is None else axis.psum(cost)


def reduce_equations(axis, H: torch.Tensor, g: torch.Tensor,
                     cost: torch.Tensor, bad=None):
    """(H, g, cost) summed over ``axis`` in one all-reduce of the packed
    ``[H | g | cost | bad]``; the cost is NaN where any rank's ``bad`` (its
    local step failure; default False) was set."""
    flag = torch.zeros((), dtype=H.dtype, device=H.device) if bad is None \
        else bad.to(H.dtype).reshape(())
    red = axis.psum(torch.cat([H.reshape(-1), g.reshape(-1),
                               cost.reshape(1), flag.reshape(1)]))
    n, p = H.numel(), g.numel()
    cost = torch.where(red[n + p + 1] > 0, float("nan"), red[n + p])
    return red[:n].reshape(H.shape), red[n:n + p].reshape(g.shape), cost


def _param_mask(graph, dtype=torch.float32) -> torch.Tensor:
    """(4FD,) 1 for free scalar params, 0 for fixed / invalid / frozen yaw."""
    free = graph.pose_valid & ~graph.pose_fixed              # (F, D)
    F, D = free.shape
    mask4 = torch.cat([free[..., None].expand(F, D, 3),
                       (free & ~graph.yaw_fixed)[..., None]], -1)
    return mask4.reshape(-1).to(dtype)


def _jtj_pairs(X, Y):
    """sum_k X[..., k, i] Y[..., k, j] -> (..., i, j)."""
    return torch.sum(X[..., :, :, None] * Y[..., :, None, :], -3)


def _jtr(X, r):
    """sum_k X[..., k, i] r[..., k] -> (..., i)."""
    return torch.sum(X * r[..., None], -2)


@highp()
def assemble_normal_equations(graph: FactorGraph, poses: torch.Tensor, *,
                              huber_delta: float = 1.0,
                              det_sphere_std: float = 0.1,
                              det_inv_dep_std: float = 0.5, axis=None,
                              bad=None):
    """(H (P, P), g (P,), cost) with the gauge/validity masks applied.

    Every family's (node_row, node_col) 4x4 blocks land in one (N*N, 16)
    scatter-add and every gradient block in one (N, 4) scatter-add. With
    ``axis`` the rank's sums are reduced before the masks
    (``reduce_equations``, with the flag ``bad``).
    """
    F, D = graph.pose_valid.shape
    N = F * D
    dtype = poses.dtype
    terms, cost = _family_terms(graph, poses, huber_delta, det_sphere_std,
                                det_inv_dep_std)
    idx_rows, blk_rows, gidx_rows, gblk_rows = [], [], [], []
    for node_a, node_b, ev, w, valid in terms:
        ws = torch.sqrt(w) * valid.to(dtype)             # sqrt IRLS weight
        ja = ev.jac_a * ws[:, None, None]
        jb = ev.jac_b * ws[:, None, None]
        r = ev.residual * ws[:, None]
        Bab = _jtj_pairs(ja, jb)
        idx_rows += [node_a * N + node_a, node_b * N + node_b,
                     node_a * N + node_b, node_b * N + node_a]
        blk_rows += [_jtj_pairs(ja, ja), _jtj_pairs(jb, jb), Bab, Bab.mT]
        gidx_rows += [node_a, node_b]
        gblk_rows += [_jtr(ja, r), _jtr(jb, r)]
    Hb = poses.new_zeros((N * N, 16))
    Hb.index_put_((torch.cat(idx_rows),),
                  torch.cat(blk_rows).reshape(-1, 16), accumulate=True)
    gb = poses.new_zeros((N, 4))
    gb.index_put_((torch.cat(gidx_rows),), torch.cat(gblk_rows),
                  accumulate=True)

    P = 4 * N
    H = Hb.reshape(N, N, 4, 4).permute(0, 2, 1, 3).reshape(P, P)
    g = gb.reshape(P)
    if axis is not None:
        H, g, cost = reduce_equations(axis, H, g, cost, bad)
    m = _param_mask(graph, dtype)
    H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    return H, g * m, cost


def _apply_step(poses: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """poses (..., F, D, 4) + dx (..., 4FD), yaw wrapped."""
    new = poses + dx.reshape(poses.shape)
    return torch.cat([new[..., :3], geo.normalize_angle(new[..., 3:])], -1)


def damped_cholesky_step(H: torch.Tensor, g: torch.Tensor,
                         lam: torch.Tensor):
    """LM step of (H + lam diag(max(diag H, 1e-6))) dx = -g by Cholesky,
    batched over leading axes. Returns (dx, bad): ``bad`` marks a system
    that is not positive definite or a non-finite dx (dx is then 0)."""
    diag = torch.clamp_min(torch.diagonal(H, dim1=-2, dim2=-1), 1e-6)
    Hd = H + torch.diag_embed(lam[..., None] * diag)
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, -g[..., None], upper=False)
    dx = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    bad = (info != 0) | ~torch.all(torch.isfinite(dx), -1)
    return torch.where(bad[..., None], 0.0, dx), bad


@highp()
def run_lm_loop(assemble, poses0: torch.Tensor, *, max_iterations: int,
                function_tolerance: float = 1e-6,
                sharded: bool = False) -> SolveResult:
    """LM trust loop over any assemble(poses) -> (H, g, cost).

    λ starts at 1e-4 and goes ×0.3 on accept, ×5 on reject, clipped to
    [1e-10, 1e10]; the loop ends at ``max_iterations``, on convergence (an
    accepted step that lowers the cost by at most ``function_tolerance``
    relative) or on a stall (a reject with λ >= 1e9). ``sharded``: the
    assembly reduces over ranks and is called as ``assemble(poses,
    bad=...)`` with the step's failure flag, so that the cost it returns
    (NaN after a failure on any rank) decides for every rank alike.
    """
    H, g, cost = assemble(poses0)
    init_cost = cost
    poses = poses0
    lam = torch.tensor(1e-4, dtype=poses0.dtype, device=poses0.device)
    it = 0
    done = False
    while not done and it < max_iterations:
        dx, bad = damped_cholesky_step(H, g, lam)
        new_poses = _apply_step(poses, dx)
        # the candidate's normal equations double as its cost evaluation
        Hn, gn, new_cost = (assemble(new_poses, bad=bad) if sharded
                            else assemble(new_poses))
        accept = torch.isfinite(new_cost) & (new_cost < cost) & ~bad
        poses = torch.where(accept, new_poses, poses)
        H = torch.where(accept, Hn, H)
        g = torch.where(accept, gn, g)
        converged = accept & (cost - new_cost <= function_tolerance * cost)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-10, 1e10)
        stalled = ~accept & (lam >= 1e9)
        it += 1
        done = bool(converged | stalled)
    return SolveResult(poses=poses, cost=cost, initial_cost=init_cost,
                       iterations=it, lam=lam)


def poses_to_device(poses, device: torch.device) -> torch.Tensor:
    """f32 poses on ``device`` from a tensor or an array (copied: JAX hands
    out read-only numpy views)."""
    if isinstance(poses, torch.Tensor):
        return poses.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(poses, np.float32), device=device)


def _device_problem(graph, poses0, device):
    from omniswarm_torch.convert import factor_graph_to_torch

    dev = resolve_device(device)
    return factor_graph_to_torch(graph, dev), poses_to_device(poses0, dev)


@highp()
def lm_solve(graph: FactorGraph, poses0, *, device="cuda",
             max_iterations: int = 100, huber_delta: float = 1.0,
             det_sphere_std: float = 0.1, det_inv_dep_std: float = 0.5,
             function_tolerance: float = 1e-6, axis=None) -> SolveResult:
    """LM solve of the masked generic graph (numpy or tensor leaves, moved
    to ``device``) from ``poses0`` (F, D, 4).

    ``axis``: the factor-sharded mode (the module docstring); ``graph`` is
    this rank's shard, the solve runs on ``axis.device`` and every rank
    returns the same replicated result.
    """
    graph, poses0 = _device_problem(
        graph, poses0, device if axis is None else axis.device)
    assemble = functools.partial(
        assemble_normal_equations, graph, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std,
        axis=axis)
    return run_lm_loop(assemble, poses0, max_iterations=max_iterations,
                       function_tolerance=function_tolerance,
                       sharded=axis is not None)


@highp()
def lm_solve_multi_init(graph: FactorGraph, poses0_batch, *, device="cuda",
                        max_iterations: int = 100, huber_delta: float = 1.0,
                        det_sphere_std: float = 0.1,
                        det_inv_dep_std: float = 0.5,
                        function_tolerance: float = 1e-6) -> SolveResult:
    """Solve from a batch of initializations (B, F, D, 4); return the best.

    Each init runs its own LM loop to its own end, with its own iteration
    count, as the reference's ``vmap`` of a ``while_loop`` does; the result
    is the lane of least finite cost (the first on ties).
    """
    graph, poses0_batch = _device_problem(graph, poses0_batch, device)
    assemble = functools.partial(
        assemble_normal_equations, graph, huber_delta=huber_delta,
        det_sphere_std=det_sphere_std, det_inv_dep_std=det_inv_dep_std)
    results = [run_lm_loop(assemble, p0, max_iterations=max_iterations,
                           function_tolerance=function_tolerance)
               for p0 in poses0_batch]
    costs = torch.stack([r.cost for r in results])
    best = int(torch.argmin(torch.where(torch.isfinite(costs), costs,
                                        float("inf"))))
    return results[best]
