"""Window-scaling sweep of the LM solve, F = 1,024 ... 16,384 keyframes.

    python -m omniswarm_torch.tools.window_scale_sweep
        [--frames 1024,2048,4096,8192,16384] [--iters 25]
        [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/window_scale_sweep.py``: at each F, 5 drones (seed
1, ``loop_every=128``: loop density F/128) solved by ``lm_solve_bt`` with a
fixed budget (``function_tolerance=0``), the median of 3 solves of
perturbed inits (``benchutil.measured_solve``). Every size runs at full
width; one that does not fit the device raises. Each row holds the
reference's keys (``frames``, ``loops``, ``ms_per_iter``, ``iter_per_s``,
``pose_updates_per_s``) and ``first_solve_s`` in place of its
``compile_s``, then the port's own readings: the final and initial cost,
the iterations, the linear path and pack ``lm_solve_bt`` chose, K1's
launches an iteration and its (m, t) levels, the relative ATE of the
solve and of raw VIO. Prints one JSON object (and writes it to
``--out``).
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
from omniswarm_torch.solver.dense import _auto_pack, lm_solve_bt, uses_pcg

DRONES = 5
REFERENCE_OUTPUTS = ("WINDOW_SCALE_*.json",)


def sweep_row(F: int, dev, *, iters: int = 25, reps: int = 3,
              repeat: bool = False) -> dict:
    """One size of the sweep (see the module docstring); with ``repeat`` a
    second solve of the same init gives ``repeat_equal``."""
    data, graph, _, init_np = sim_problem(dev, num_drones=DRONES,
                                          num_frames=F, seed=1,
                                          loop_every=128)
    solve = functools.partial(lm_solve_bt, graph, device=dev,
                              max_iterations=iters, function_tolerance=0.0)
    res, got = measured_solve(solve, init_np, dev, reps, repeat)
    it, dt = res.iterations, got.pop("seconds")
    poses = res.poses.cpu().numpy()
    row = {
        "frames": F,
        "loops": int(graph.loops.valid.sum()),
        "ms_per_iter": dt / it * 1e3,
        "iter_per_s": it / dt,
        "pose_updates_per_s": it * F * DRONES / dt,
        "first_solve_s": got.pop("first_solve_s"),
        "final_cost": float(res.cost),
        "initial_cost": float(res.initial_cost),
        "iterations": it,
        "linear": "pcg" if uses_pcg("auto", False, F,
                                    graph.loops.valid.shape[0]) else "smw",
        "pack": _auto_pack(F, 4 * DRONES),
        "k1_launches_per_iter": got["k1_launches"] / it,
        **got,
        "relative_ate": metrics.mean_relative_ate(poses, data.gt),
        "vio_relative_ate": metrics.mean_relative_ate(data.vio, data.gt),
    }
    print(f"[sweep] F={F}: {row['ms_per_iter']:.3f} ms/iter, "
          f"{row['pose_updates_per_s'] / 1e6:.3f}M pose-updates/s, cost "
          f"{row['final_cost']!r}, first solve {row['first_solve_s']:.2f} s",
          file=sys.stderr, flush=True)
    return row


def sweep(device="cuda", frames=(1024, 2048, 4096, 8192, 16384),
          iters: int = 25, reps: int = 3) -> dict:
    """The sweep's JSON object."""
    dev = resolve_device(device)
    rows = [sweep_row(F, dev, iters=iters, reps=reps) for F in frames]
    name = card(dev)
    return {"description": f"Single-card BT-LM window scaling ({name}, "
                           f"loop density F/128, {iters}-iteration solves, "
                           f"median of {reps})",
            "card": name, "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.window_scale_sweep",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", default="1024,2048,4096,8192,16384")
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is not None:
        refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    with torch.no_grad():
        result = sweep(args.device, [int(x) for x in args.frames.split(",")],
                       args.iters)
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
