"""The flagship solve end to end: simulate, build, solve, score.

Counterpart of ``__graft_entry__.py::entry`` and of the headline row of
``bench.py``: 5 drones x 100 keyframes (the reference's production window,
loop-5-drone.launch max_keyframe_num=100), seed 0, solved by the
block-tridiagonal + Woodbury LM and scored by mean relative ATE.

    python -m omniswarm_torch.entry            # on the GPU
"""
from __future__ import annotations

import json
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from omniswarm_torch import sim
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.eval import metrics
from omniswarm_torch.solver.dense import dense_graph_from_sim, lm_solve_bt
from omniswarm_torch.solver.fused_level import fused_reduction_level


class EntryResult(NamedTuple):
    poses: np.ndarray         # (F, D, 4) solved poses
    cost: float               # final cost
    initial_cost: float
    iterations: int           # LM iterations run
    relative_ate: float       # mean relative ATE of the solve vs ground truth
    vio_relative_ate: float   # the same for the raw VIO trajectory
    k1_launches: int          # fused-level kernel launches during the solve
    solve_s: float            # wall seconds of lm_solve_bt, synchronised
    num_loops: int
    num_detections: int


def entry(device="cuda", num_frames: int = 100, num_drones: int = 5,
          seed: int = 0, max_iterations: int = 20,
          fused: Optional[bool] = None, linear: str = "auto",
          exact_linear: bool = False) -> EntryResult:
    """Run steps 1-4 of the main path and return the scored result.

    The solve runs with function_tolerance 0, so every one of the
    ``max_iterations`` LM iterations runs: the result then compares with
    the reference's near-converged cost and the kernel's launch count is
    fixed (4 per iteration at F=100). ``fused`` overrides the solver's
    fused-level choice (default: on for packed blocks); ``linear`` and
    ``exact_linear`` pick the linear path (``lm_solve_bt``).
    """
    dev = resolve_device(device)
    data = sim.generate(sim.SimParams(num_drones=num_drones,
                                      num_frames=num_frames, seed=seed))
    graph = dense_graph_from_sim(data)
    launches0 = fused_reduction_level.launches
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = lm_solve_bt(graph, data.vio, device=dev,
                      max_iterations=max_iterations,
                      function_tolerance=0.0, fused=fused, linear=linear,
                      exact_linear=exact_linear)
    poses = res.poses.cpu().numpy()       # synchronises
    solve_s = time.perf_counter() - t0
    return EntryResult(
        poses=poses, cost=float(res.cost),
        initial_cost=float(res.initial_cost), iterations=res.iterations,
        relative_ate=metrics.mean_relative_ate(poses, data.gt),
        vio_relative_ate=metrics.mean_relative_ate(data.vio, data.gt),
        k1_launches=fused_reduction_level.launches - launches0,
        solve_s=solve_s, num_loops=len(data.loops),
        num_detections=len(data.detections))


if __name__ == "__main__":
    out = entry()
    print(json.dumps({k: v for k, v in out._asdict().items()
                      if k != "poses"}))
