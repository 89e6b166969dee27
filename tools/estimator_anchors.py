#!/usr/bin/env python3
"""Reference anchors for the estimator phase of ``chip_smoke.py``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/estimator_anchors.py

Runs the session of ``omniswarm_torch/estimator_entry.py`` (5 drones x 150
frames, seed 0, 20% loop outliers of magnitude 4, a solve every 10th frame,
``max_solver_time=0``) through the JAX package's estimator (the reference)
on the CPU, with ``acpt_cost=1000``, and prints one JSON object to paste
into ``chip_smoke.py``'s ``ESTIMATOR_ANCHORS``: per solve the window's frame
indices (as [first, last] runs), ``finish_init``, the cost,
``cost / acpt_cost``, the PCM inlier sets per drone pair (count and a hash of
the loop keys) and the linear path; then the final relative ATE and the
covariance diagonals of each drone's newest pose. The per-solve lines go to
stderr as the run goes. The session is driven by the port's
``drive_session``, so both packages see the same stream. About 9 minutes and
2 GB on one CPU core.
"""
from __future__ import annotations

import json
import sys
import time


def main() -> int:
    from omniswarm_torch.estimator_entry import (SESSION, drive_session,
                                                 frame_runs, session_params)
    from omniswarm_tpu import sim
    from omniswarm_tpu.config import SolverParams
    from omniswarm_tpu.swarm import DetRecord, LoopRecord, SwarmEstimator
    from omniswarm_tpu.utils.telemetry import GLOBAL

    acpt_cost = 1000.0
    t0 = time.perf_counter()
    data = sim.generate(sim.SimParams(**SESSION))
    est = SwarmEstimator(session_params(SolverParams, acpt_cost), rng_seed=0)
    finalize = est.finalize_solve

    def logged(prep, res):
        out = finalize(prep, res)
        print(f"solve {est.solve_count} F={out['num_frames']} cost "
              f"{out['cost']} iterations {out['iterations']} finish_init "
              f"{out['finish_init']} {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        return out

    est.finalize_solve = logged
    out = drive_session(est, data, LoopRecord, DetRecord, GLOBAL)
    anchors = dict(
        acpt_cost=acpt_cost,
        solves=[dict(frames=frame_runs(s["frames"]),
                     finish_init=s["finish_init"],
                     cost=round(s["cost"], 6),
                     cost_over_acpt=round(s["cost_over_acpt"], 6),
                     inliers=s["inliers"], linear=s["linear"],
                     pack=s["pack"], lanes=s["lanes"])
                for s in out["solves"]],
        relative_ate=round(out["final"]["relative_ate"], 6),
        cov_diag={d: [round(v, 9) for v in diag]
                  for d, diag in out["final"]["cov_diag"].items()})
    print(json.dumps(anchors))
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
