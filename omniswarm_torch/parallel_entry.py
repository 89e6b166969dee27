"""The multi-device dryrun: all three layouts against single-process solves.

Counterpart of ``__graft_entry__.py::dryrun_multichip``:

    python -m omniswarm_torch.parallel_entry --world 4 [--backend gloo]

spawns ``world`` ranks (``parallel.launch.run_ranks``) and runs, with 20 LM
iterations and ``function_tolerance`` 0,

1. the factor-sharded generic LM (``parallel.sharded_solver``) on 5 drones
   x 64 frames (seed 1, detections on);
2. the frame-sharded window LM (``parallel.sharded_window``: halo'd
   assembly, SPIKE, reduced Woodbury capacitance) on 5 x 256 (seed 2,
   ``loop_every=16``);
3. the fleet lanes (``parallel.swarm_batch``), one 5 x 32 problem a rank
   (seeds 10 + rank, loop capacity 64);

and holds each to the same problem solved in this process (``lm_solve``,
``lm_solve_bt``, one ``lm_solve_bt`` a lane) at the reference's 5e-3
relative cost, printing the deltas. The backend comes from the arguments
and the world: ``nccl`` when every rank has a card of its own, else
``gloo`` (several ranks then share the card); it never changes after an
error.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omniswarm_torch import sim
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.parallel.launch import call_each, run_ranks
from omniswarm_torch.sim.pipeline import build_graph_from_sim
from omniswarm_torch.solver.dense import dense_graph_from_sim, lm_solve_bt
from omniswarm_torch.solver.gauss_newton import lm_solve

ITERS = 20
BAR = 5e-3
PAR = "omniswarm_torch.parallel"


def default_backend(world: int, device) -> str:
    """``nccl`` when ``device`` is CUDA and there is a card for every rank,
    else ``gloo``."""
    dev = torch.device(device)
    return "nccl" if (dev.type == "cuda"
                      and world <= torch.cuda.device_count()) else "gloo"


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-9)


def dryrun_multichip(world: int, device="cuda", backend=None) -> dict:
    """Run the three layouts on ``world`` ranks and hold each to its
    single-process solve; raises when a layout misses the 5e-3 bar.
    Returns the costs and relative deltas."""
    dev = resolve_device(device)
    backend = backend or default_backend(world, dev)
    kw = dict(max_iterations=ITERS, function_tolerance=0.0)

    data1 = sim.generate(sim.SimParams(num_drones=5, num_frames=64, seed=1))
    graph1, init1 = build_graph_from_sim(data1, enable_detections=True)
    big = sim.generate(sim.SimParams(num_drones=5, num_frames=256, seed=2,
                                     loop_every=16))
    graph2 = dense_graph_from_sim(big)
    lanes = [sim.generate(sim.SimParams(num_drones=5, num_frames=32,
                                        seed=10 + s)) for s in range(world)]
    graphs3 = [dense_graph_from_sim(d, max_loops=64) for d in lanes]
    inits3 = [d.vio for d in lanes]
    calls = [(f"{PAR}.sharded_solver:sharded_lm_solve",
              dict(graph=graph1, poses0=init1, **kw)),
             (f"{PAR}.sharded_window:lm_solve_bt_sharded",
              dict(graph=graph2, poses0=big.vio, **kw)),
             (f"{PAR}.swarm_batch:solve_fleet",
              dict(graphs=graphs3, inits=inits3, **kw))]
    res1, res2, res3 = (c["result"] for c in run_ranks(
        call_each, world, backend=backend, device=dev.type, args=(calls,))[0])

    out = dict(world=world, backend=backend)
    c1 = float(res1.cost)
    r1 = float(lm_solve(graph1, init1, device=dev, **kw).cost)
    out["factor_sharded"] = dict(cost=c1, single=r1, rel_delta=_rel(c1, r1))
    print(f"factor-sharded F=64 D=5: sharded cost {c1:.4f} single {r1:.4f} "
          f"rel_delta {_rel(c1, r1):.2e}", flush=True)

    c2 = float(res2.cost)
    r2 = float(lm_solve_bt(graph2, big.vio, device=dev, **kw).cost)
    out["frame_sharded"] = dict(cost=c2, single=r2, rel_delta=_rel(c2, r2),
                                loops=len(big.loops))
    print(f"frame-sharded F=256 D=5 loops={len(big.loops)}: sharded cost "
          f"{c2:.4f} single {r2:.4f} rel_delta {_rel(c2, r2):.2e}",
          flush=True)

    costs = np.asarray(res3.cost, np.float64)
    singles = [float(lm_solve_bt(g, i, device=dev, **kw).cost)
               for g, i in zip(graphs3, inits3)]
    rel3 = max(_rel(c, r) for c, r in zip(costs, singles))
    out["fleet"] = dict(cost=costs.tolist(), single=singles, rel_delta=rel3)
    print(f"fleet {world} lanes F=32 D=5: per-lane max rel_delta {rel3:.2e} "
          f"(no data collective)", flush=True)

    for name in ("factor_sharded", "frame_sharded", "fleet"):
        row = out[name]
        if not (np.all(np.isfinite(row["cost"]))
                and row["rel_delta"] <= BAR):
            raise RuntimeError(f"{name} at world {world} ({backend}): "
                               f"relative delta {row['rel_delta']} > {BAR}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args()
    print(json.dumps(dryrun_multichip(args.world, args.device,
                                      args.backend)))


if __name__ == "__main__":
    main()
