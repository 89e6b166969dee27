"""Fleet lanes against lock-step: where a stacked per-lane graph costs.

    python -m omniswarm_torch.tools.profile_fleet [--device cuda|cpu]
        [--out PATH]

Counterpart of ``tools/profile_fleet.py``: 8 problems of 5 drones x 100
keyframes (seeds 100-107) with ONE loop capacity (the largest lane's loop
count rounded up to 16, at least 8), each stage timed alone
(``benchutil.stage_ms``, 30 calls, each fed from the one
before) on the lanes of ``lm_solve_bt_batched`` as it runs them, one after
another:

- ``assemble_shared_ms``: the 8 lanes' assembly on lane 0's graph, shared
  (the batch of 8's lock-step mode);
- ``assemble_stacked_ms``: on each lane's own graph of the stack
  (``parallel/swarm_batch.py::stack_graphs``, the fleet mode);
- ``smw_ms``: the warm Woodbury solve (the same shapes in both modes);
- ``iter_stacked_ms``, ``iter_shared_ms``: a full iteration in each mode.

Prints a line a stage and one JSON object (with ``cap``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omniswarm_torch import sim
from omniswarm_torch.benchutil import chain, nudge, stage_ms
from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.parallel.swarm_batch import stack_graphs
from omniswarm_torch.solver.dense import (_lane, assemble_lanes,
                                          dense_graph_from_sim, smw_lanes)

LANES = 8


@highp()
def profile(device="cuda", reps: int = 30) -> dict:
    """The stage times (see the module docstring)."""
    dev = resolve_device(device)
    sims = [sim.generate(sim.SimParams(num_drones=5, num_frames=100,
                                       seed=100 + k)) for k in range(LANES)]
    cap = max(8, ((max(len(d.loops) for d in sims) + 15) // 16) * 16)
    print(f"lane loops: {[len(d.loops) for d in sims]} cap={cap}",
          flush=True)
    graphs = [dense_graph_from_sim(d, max_loops=cap) for d in sims]
    stacked = dense_graph_to_torch(stack_graphs(graphs), dev)
    lanes = {"stacked": [_lane(stacked, b) for b in range(LANES)],
             "shared": [_lane(stacked, 0)] * LANES}
    poses = torch.from_numpy(np.stack(
        [np.asarray(d.vio, np.float32) for d in sims])).to(dev)
    lam = torch.full((LANES,), 1e-4, device=dev)

    def assemble(mode, p):
        return assemble_lanes(lanes[mode], p)

    def smw(A, Bo, g, U, warm):
        return smw_lanes(A, Bo, g, U.to(torch.bfloat16), lam, warm)

    out = {"cap": cap}
    for mode in ("shared", "stacked"):
        out[f"assemble_{mode}_ms"] = stage_ms(
            f"assemble {mode}-graph (B=8)",
            chain(lambda p, m=mode: nudge(p, assemble(m, p)[2]), poses),
            reps)

    A0, B0, g0, U0, _ = assemble("stacked", poses)
    w0 = smw(A0, B0, g0, U0, [None] * LANES)[1]

    def smw_step(carry):
        g, w = carry
        dx, w = smw(A0, B0, g, U0, w)
        return nudge(g, dx), w
    out["smw_ms"] = stage_ms(f"smw warm (B=8, C={U0.shape[-1]})",
                             chain(smw_step, (g0, w0)), reps)

    for mode in ("stacked", "shared"):
        A, Bo, g, U, _ = assemble(mode, poses)

        def iteration(carry, m=mode):
            p, w = carry
            dx, w = smw(*assemble(m, p)[:4], w)
            return nudge(p, dx), w
        out[f"iter_{mode}_ms"] = stage_ms(
            f"full iter {mode} (B=8)",
            chain(iteration, (poses, smw(A, Bo, g, U, [None] * LANES)[1])),
            reps)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.profile_fleet",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with torch.no_grad():
        out = profile(args.device)
    print(json.dumps(out), flush=True)
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
