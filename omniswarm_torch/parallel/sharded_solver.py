"""Factor-sharded bundle adjustment over ranks.

Counterpart of ``omniswarm_tpu/parallel/sharded_solver.py``. Every factor
family is padded to a multiple of the world (padded slots invalid) and each
rank evaluates residuals and Jacobians of its slice only; the normal
equations are summed in ONE all-reduce per assembly (``gauss_newton``'s
``axis`` mode: the packed ``[H | g | cost | bad]``) and the dense solve
runs replicated. The pose masks and the poses are whole on every rank.
"""
from __future__ import annotations

import torch

from omniswarm_torch.convert import dense_graph_to_torch, factor_graph_to_torch
from omniswarm_torch.parallel.collectives import Axis
from omniswarm_torch.solver.dense import DenseGraph, lm_solve_dense
from omniswarm_torch.solver.gauss_newton import SolveResult, lm_solve
from omniswarm_torch.solver.graph import FactorGraph

FAMILIES = ("ranges", "odoms", "loops", "dets")


def make_mesh(device, group=None) -> Axis:
    """The Axis over ``group`` (default: the whole initialised world),
    computing on ``device``; ``launch.run_ranks`` hands one to every
    rank."""
    return Axis(device, group)


def _map_families(graph: FactorGraph, fn) -> FactorGraph:
    return graph._replace(**{
        name: type(fam)(*(fn(x) for x in fam))
        for name, fam in ((n, getattr(graph, n)) for n in FAMILIES)})


def shard_graph_factors(graph: FactorGraph, n_shards: int) -> FactorGraph:
    """Every factor family padded to a multiple of ``n_shards`` rows; the
    padded slots are invalid and contribute nothing."""
    def pad(x):
        rem = -x.shape[0] % n_shards
        return x if rem == 0 else torch.cat(
            [x, x.new_zeros((rem,) + x.shape[1:])], 0)

    return _map_families(graph, pad)


def graph_shard(graph: FactorGraph, axis) -> FactorGraph:
    """This rank's contiguous slice of each (padded) factor family; the
    pose masks stay whole."""
    def rows(x):
        n = x.shape[0] // axis.size
        return x[axis.index * n:(axis.index + 1) * n]

    return _map_families(graph, rows)


def sharded_lm_solve(graph: FactorGraph, poses0, axis,
                     **solve_kwargs) -> SolveResult:
    """The generic LM (``gauss_newton.lm_solve``) with the factors split
    over ``axis``. Every rank is handed the whole graph (numpy or tensor
    leaves) and returns the same whole result."""
    graph = factor_graph_to_torch(graph, axis.device)
    shard = graph_shard(shard_graph_factors(graph, axis.size), axis)
    return lm_solve(shard, poses0, axis=axis, **solve_kwargs)


def dense_factor_shard(graph: DenseGraph, axis) -> DenseGraph:
    """The frame-dense graph with its validity masks cut to this rank's
    factors: the range and detection grids and the odometry rows by
    contiguous blocks of frames, the loops by contiguous blocks of slots."""
    def mine(n: int, like: torch.Tensor) -> torch.Tensor:
        return (torch.arange(n, device=like.device) * axis.size // max(n, 1)
                ) == axis.index

    def cut(valid):
        own = mine(valid.shape[0], valid)
        return valid & own.reshape((-1,) + (1,) * (valid.ndim - 1))

    return graph._replace(
        range_valid=cut(graph.range_valid), odom_valid=cut(graph.odom_valid),
        det_valid=cut(graph.det_valid),
        loops=graph.loops._replace(valid=cut(graph.loops.valid)))


def sharded_lm_solve_dense(graph: DenseGraph, poses0, axis,
                           **solve_kwargs) -> SolveResult:
    """``dense.lm_solve_dense`` with the factors split over ``axis``
    (``dense_factor_shard``); whole graph in, whole result out."""
    shard = dense_factor_shard(dense_graph_to_torch(graph, axis.device), axis)
    return lm_solve_dense(shard, poses0, axis=axis, **solve_kwargs)
