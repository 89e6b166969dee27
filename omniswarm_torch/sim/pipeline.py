"""SimData -> FactorGraph assembly (the generic path's graph).

Counterpart of ``omniswarm_tpu/sim/pipeline.py``: simulator measurements
become masked factor arrays and VIO becomes both the ego-motion chain and the
initial guess. Host-side numpy; the solvers move the graph to the device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from omniswarm_torch.core import geometry as geo
from omniswarm_torch.sim.simulator import SimData, delta_pose_np
from omniswarm_torch.solver.graph import (FactorGraph, GraphBuilder,
                                          diag_sqrt_info)


def build_graph_from_sim(
    sim: SimData,
    self_id: int = 0,
    *,
    distance_cov: float = 0.02,
    vo_cov_pos_per_meter: float = 0.002,
    vo_cov_yaw_per_meter: float = 0.0001,
    enable_distance: bool = True,
    enable_loops: bool = True,
    enable_detections: bool = False,
    loops_override: Optional[Sequence] = None,
    max_ranges: Optional[int] = None,
    max_odoms: Optional[int] = None,
    max_loops: Optional[int] = None,
    max_dets: Optional[int] = None,
) -> tuple[FactorGraph, np.ndarray]:
    """Returns (graph, init_poses (F, D, 4) f32).

    - VIO deltas -> ego-motion factors with drift-scaled sqrt information
      (covariance proportional to the distance travelled);
    - the UWB range matrix -> one range factor per frame and unordered pair;
    - loop measurements -> loop factors; detections -> bearing factors;
    - the self drone's first pose is gauge-fixed.
    """
    F, D = sim.gt.shape[:2]

    def cap(n, default):
        return n if n is not None else max(int(default), 8)

    b = GraphBuilder(
        F, D,
        max_ranges=cap(max_ranges, F * D * (D - 1) // 2),
        max_odoms=cap(max_odoms, F * D),
        max_loops=cap(max_loops, len(sim.loops) if loops_override is None
                      else len(loops_override)),
        max_dets=cap(max_dets, len(sim.detections)),
    )

    for k in range(F):
        for d in range(D):
            b.set_pose_valid(k, d, fixed=(k == 0 and d == self_id))

    for d in range(D):
        for k in range(F - 1):
            dp = delta_pose_np(sim.vio[k, d], sim.vio[k + 1, d])
            seg_len = max(float(np.linalg.norm(dp[:3])), 1e-3)
            pos_std = np.sqrt(vo_cov_pos_per_meter * seg_len)
            yaw_std = np.sqrt(vo_cov_yaw_per_meter * seg_len)
            b.add_odom(d, k, k + 1, dp, diag_sqrt_info(pos_std, yaw_std))

    if enable_distance:
        for k in range(F):
            for da in range(D):
                for db in range(da + 1, D):
                    if sim.range_valid[k, da, db]:
                        b.add_range(k, da, db, float(sim.ranges[k, da, db]),
                                    cov=distance_cov)

    if enable_loops:
        for lp in (loops_override if loops_override is not None
                   else sim.loops):
            b.add_loop(lp.frame_a, lp.drone_a, lp.frame_b, lp.drone_b,
                       lp.dpose, diag_sqrt_info(lp.pos_std, lp.yaw_std))

    if enable_detections:
        for det in sim.detections:
            tb = geo.tangent_base_from_unit_np(det.direction)
            b.add_detection(det.frame, det.drone_a, det.frame, det.drone_b,
                            det.direction, tb, det.inv_dep)

    return b.build(), np.asarray(sim.vio, np.float32)
