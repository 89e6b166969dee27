"""The F=100 window's pack x fused grid, single solve and batch of 8.

    python -m omniswarm_torch.tools.profile_f100 [--iters 100]
        [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/profile_f100.py``: 5 drones x 100 keyframes (seed 0)
solved by ``lm_solve_bt`` (``function_tolerance=0``) at pack 1, 2 and 4,
with the warm levels through K1 (``_fused``) and through the plain level
(fused levels need packed blocks: none at pack 1), and the batch of 8
inits (``benchutil.batch_inits``) through ``lm_solve_bt_batched`` at each
pack (its lanes run unfused, one after another). Rates are medians over
5 perturbed inits (``benchutil.measured_solve``). The keys are
``F100_GRID_r05.json``'s: ``single_pack<p>[_fused]`` with ``iter_per_s``
and ``cost_delta`` (relative to ``single_pack1``'s cost), and
``batch8_pack<p>`` with ``aggregate_iter_per_s``; each single run also
holds its cost, its K1 launches and (m, t) levels (the port's readings).
Prints one JSON object.
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from omniswarm_torch.benchutil import (BATCH, batch_inits, card,
                                       measured_solve,
                                       refuse_reference_output, sim_problem)
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.solver.dense import lm_solve_bt, lm_solve_bt_batched

PACKS = (1, 2, 4)
REFERENCE_OUTPUTS = ("F100_GRID_*.json",)


def grid(device="cuda", iters: int = 100, reps: int = 5) -> dict:
    """The grid's JSON object (see the module docstring)."""
    dev = resolve_device(device)
    _, graph, _, init_np = sim_problem(dev, num_drones=5, num_frames=100,
                                       seed=0)
    kw = dict(device=dev, max_iterations=iters, function_tolerance=0.0)
    res, base_cost = {"card": card(dev)}, None
    for pack in PACKS:
        for fused in (False, True):
            if fused and pack == 1:
                continue
            key = f"single_pack{pack}" + ("_fused" if fused else "")
            r, got = measured_solve(functools.partial(
                lm_solve_bt, graph, pack=pack, fused=fused, **kw),
                init_np, dev, reps)
            cost = float(r.cost)
            if base_cost is None:
                base_cost = cost
            res[key] = {"iter_per_s": r.iterations / got["seconds"],
                        "cost_delta": abs(cost - base_cost) / abs(base_cost),
                        "cost": cost, "k1_launches": got["k1_launches"],
                        "k1_levels": got["k1_levels"]}
            print(f"[f100] {key}: {res[key]}", flush=True)
    inits = batch_inits(init_np)
    for pack in PACKS:
        key = f"batch8_pack{pack}"
        r, got = measured_solve(functools.partial(
            lm_solve_bt_batched, graph, pack=pack, **kw), inits, dev, reps)
        res[key] = {"aggregate_iter_per_s":
                    r.iterations * BATCH / got["seconds"]}
        print(f"[f100] {key}: {res[key]}", flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.profile_f100",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is not None:
        refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    with torch.no_grad():
        res = grid(args.device, args.iters)
    print(json.dumps(res), flush=True)
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
