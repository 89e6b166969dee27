"""The loop-dense window: PCG at 24/16/12/8 CG sweeps against Woodbury.

    python -m omniswarm_torch.tools.bench_dense_loops [--iters 25]
        [--frames 1024] [--loop-every 2] [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/bench_dense_loops.py``: 5 drones x ``--frames``
(seed 4; ``--loop-every`` 2 gives 2,555 loops at F=1024, and sweeps the
loop density), solved by ``lm_solve_bt`` with ``function_tolerance=0`` on
PCG at ``cg_iters`` 24, 16, 12 and 8 (each warm-started from the previous
LM step), then with ``linear="smw"`` (the Newton-Schulz Woodbury path).
Each run's ms per iteration is the median over 3 perturbed inits
(``benchutil.measured_solve``); its final cost is the unperturbed first
solve's; ``cost_vs_smw`` compares each PCG run with the Woodbury run.
``measure(exact=True)`` adds the exact Woodbury path
(``exact_linear=True``), the ground truth the PCG runs approach, as
``exact`` with ``cost_vs_exact`` (``chip_smoke.py`` phase 13a).
Besides the reference's keys each run holds the port's own readings:
iterations, first-solve seconds, K1's launches and (m, t) levels, the
relative ATE of the solve and of raw VIO. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys

import torch

from omniswarm_torch.benchutil import (card, measured_solve,
                                       refuse_reference_output, sim_problem)
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.eval import metrics
from omniswarm_torch.solver.dense import lm_solve_bt

CG_ITERS = (24, 16, 12, 8)
REFERENCE_OUTPUTS = ("DENSE_LOOPS_*.json",)


def runs(exact: bool = False) -> dict:
    """The runs by key: ``pcg_cg<n>``, ``smw`` and with ``exact`` ``exact``,
    each as ``lm_solve_bt`` keywords."""
    out = {f"pcg_cg{n}": dict(linear="pcg", cg_iters=n) for n in CG_ITERS}
    out["smw"] = dict(linear="smw")
    if exact:
        out["exact"] = dict(exact_linear=True)
    return out


def measure(device="cuda", frames: int = 1024, loop_every: int = 2,
            iters: int = 25, reps: int = 3, exact: bool = False,
            repeat: bool = False) -> dict:
    """The tool's JSON object; ``repeat`` solves each unperturbed init
    twice (``repeat_equal``)."""
    dev = resolve_device(device)
    data, graph, _, init_np = sim_problem(dev, num_drones=5,
                                          num_frames=frames, seed=4,
                                          loop_every=loop_every)
    print(f"[dense-loops] F={frames} loops={len(data.loops)}",
          file=sys.stderr, flush=True)
    vio_ate = metrics.mean_relative_ate(data.vio, data.gt)
    res = {"frames": frames, "loops": len(data.loops), "card": card(dev)}
    for key, kw in runs(exact).items():
        solve = functools.partial(lm_solve_bt, graph, device=dev,
                                  max_iterations=iters,
                                  function_tolerance=0.0, **kw)
        r, got = measured_solve(solve, init_np, dev, reps, repeat)
        dt = got.pop("seconds")
        res[key] = {"ms_per_iter": dt / r.iterations * 1e3,
                    "iter_per_s": r.iterations / dt,
                    "final_cost": float(r.cost),
                    "initial_cost": float(r.initial_cost),
                    "iterations": r.iterations, **got,
                    "relative_ate": metrics.mean_relative_ate(
                        r.poses.cpu().numpy(), data.gt),
                    "vio_relative_ate": vio_ate}
        print(f"[dense-loops] {key}: {json.dumps(res[key])}",
              file=sys.stderr, flush=True)
    for truth in ("smw", "exact"):
        if truth not in res:
            continue
        ref = res[truth]["final_cost"]
        for n in CG_ITERS:
            if f"pcg_cg{n}" in res:
                res[f"pcg_cg{n}"][f"cost_vs_{truth}"] = (
                    (res[f"pcg_cg{n}"]["final_cost"] - ref)
                    / max(abs(ref), 1e-9))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.bench_dense_loops",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--loop-every", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is not None:
        refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    with torch.no_grad():
        res = measure(args.device, args.frames, args.loop_every, args.iters)
    print(json.dumps(res), flush=True)
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
