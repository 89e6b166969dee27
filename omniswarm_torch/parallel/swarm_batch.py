"""Fleet lanes: many independent sliding-window problems, split over ranks.

Counterpart of ``omniswarm_tpu/parallel/swarm_batch.py``. Each drone of a
fleet owns its own window; served centrally, the problems are independent,
so they solve as one lock-step batched LM (``dense.lm_solve_bt_batched``
with a stacked graph) and the lane axis splits over the ranks with no data
exchanged during the solve. When the world divides the lane count each rank
solves its lanes and ONE gather (labelled ``output``) returns the whole
result; otherwise every rank solves every lane (the reference's replicated
placement) and nothing is exchanged.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from omniswarm_torch.solver.dense import DenseGraph, _lane, lm_solve_bt_batched
from omniswarm_torch.solver.gauss_newton import SolveResult


def _tree_map(fn, *trees):
    """fn over the leaves of equal-structure named tuples (None kept)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)


def stack_graphs(graphs: Sequence[DenseGraph]) -> DenseGraph:
    """Same-shape DenseGraphs stacked on a new leading lane axis; numpy
    leaves stack on the host (the graph then moves to the device in one
    pass)."""
    def stack(*xs):
        if any(isinstance(x, torch.Tensor) for x in xs):
            return torch.stack([torch.as_tensor(x) for x in xs], 0)
        return np.stack([np.asarray(x) for x in xs], 0)

    return _tree_map(stack, *graphs)


def lm_solve_multigraph(graphs: DenseGraph, poses0, *, device="cuda",
                        **kw) -> SolveResult:
    """The batched LM with one graph per lane (a stacked DenseGraph):
    ``dense.lm_solve_bt_batched``, whose Newton-Schulz Woodbury path the
    lanes take (``exact_linear=True`` for the exact one)."""
    return lm_solve_bt_batched(graphs, poses0, device=device, **kw)


def solve_fleet(graphs: Sequence[DenseGraph], inits, axis=None, *,
                device="cuda", **kw) -> SolveResult:
    """Solve many per-drone problems, the lanes split over ``axis``.

    Without ``axis`` the batch solves on ``device``; with it, on
    ``axis.device``, the lanes split when the world divides their count
    (replicated otherwise). ``iterations`` is the lock-step count over all
    lanes (the largest rank's: a lane that is done stops changing)."""
    stacked = stack_graphs(graphs)
    poses0 = np.stack([np.asarray(x, np.float32) for x in inits], 0)
    if axis is None:
        return lm_solve_multigraph(stacked, poses0, device=device, **kw)
    B, P = poses0.shape[0], axis.size
    if B % P:
        return lm_solve_multigraph(stacked, poses0, device=axis.device, **kw)
    lanes = slice(axis.index * B // P, (axis.index + 1) * B // P)
    res = lm_solve_multigraph(_lane(stacked, lanes), poses0[lanes],
                              device=axis.device, **kw)
    # ONE gather of [poses | cost | initial cost | lam | iterations]
    n = res.poses.numel()
    part = torch.cat([res.poses.reshape(-1), res.cost, res.initial_cost,
                      res.lam, res.cost.new_tensor([res.iterations])])
    allp = axis.all_gather(part, label="output")
    b = B // P
    return SolveResult(
        poses=allp[:, :n].reshape((B,) + res.poses.shape[1:]),
        cost=allp[:, n:n + b].reshape(B),
        initial_cost=allp[:, n + b:n + 2 * b].reshape(B),
        iterations=int(allp[:, -1].max()),
        lam=allp[:, n + 2 * b:n + 3 * b].reshape(B))
