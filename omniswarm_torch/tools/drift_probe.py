"""Headline drift probe: this tree's headline measurement against another
checkout's, on the same card in one invocation.

    python -m omniswarm_torch.tools.drift_probe DIR [--device cuda|cpu]

Counterpart of ``tools/drift_probe.py``. One measurement is the
headline's (``bench.py``'s per-problem LM iterations a second): the 5-drone
x 100-frame simulated window (``sim.generate`` seed 0,
``dense_graph_from_sim``) solved by ``lm_solve_bt`` with
``max_iterations=100`` and ``function_tolerance=0.0``, one warm solve, then
5 solves from inits perturbed as the reference perturbs them (one
coordinate by (k+1)e-6 plus a uniform draw below 1e-6, here from a seeded
generator), each synchronised on the host clock; iterations a second =
the warm solve's iterations / the median wall time.

The measurements alternate the trees (DIR, this, this, DIR). Each runs in
a child process of its own, since two packages named ``omniswarm_torch``
cannot live in one interpreter: the child runs this file as a script with
the tree first on ``sys.path``, refuses to measure (exit 3) when
``omniswarm_torch`` resolves outside that tree, and calls only the API
every checkout of the port has had (``sim``, ``dense_graph_from_sim``,
``dense_graph_to_torch``, ``lm_solve_bt``). A tree's kernels build into its
own ``build/kernels/``. The child counts K1's launches
(``fused_reduction_level.launches``) over all its solves.

Prints one JSON line per measurement and a summary line (this tree's
iterations a second over DIR's, and whether iteration counts and costs
agree), each with the card's name and power limit. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# the reference's problem
HEADLINE = dict(drones=5, frames=100, reps=5)
ORDER = ("other", "this", "this", "other")
THIS_TREE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))))
REFUSED = 3                       # the child's exit code for a foreign tree


def measure(device: str, drones: int, frames: int, reps: int) -> dict:
    """One headline measurement with the ``omniswarm_torch`` on
    ``sys.path`` (run inside the child)."""
    import numpy as np
    import torch

    from omniswarm_torch import sim
    from omniswarm_torch.convert import dense_graph_to_torch
    from omniswarm_torch.solver import fused_level
    from omniswarm_torch.solver.dense import dense_graph_from_sim, lm_solve_bt

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)      # deterministic CPU scatter-adds

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def solve(init):
        return lm_solve_bt(graph, init, device=device, max_iterations=100,
                           function_tolerance=0.0)

    data = sim.generate(sim.SimParams(num_drones=drones, num_frames=frames,
                                      seed=0))
    graph = dense_graph_to_torch(dense_graph_from_sim(data), dev)
    init_np = np.asarray(data.vio, np.float32)
    k1 = fused_level.fused_reduction_level
    k1_0 = getattr(k1, "launches", 0)
    r = solve(torch.as_tensor(init_np, device=dev))
    sync()
    iters = int(r.iterations)
    rng = np.random.default_rng(0)
    ts, rep_iters = [], []
    for k in range(reps):
        o = init_np.copy()
        o[0, 0, 0] += (k + 1) * 1e-6 + rng.uniform(0, 1e-6)
        ik = torch.as_tensor(o, device=dev)
        sync()
        t0 = time.perf_counter()
        out = solve(ik)
        sync()
        ts.append(time.perf_counter() - t0)
        rep_iters.append(int(out.iterations))
    dt = statistics.median(ts)
    launches = getattr(k1, "launches", 0) - k1_0
    import omniswarm_torch

    return dict(package=os.path.dirname(os.path.realpath(
                    omniswarm_torch.__file__)),
                device=device, drones=drones, frames=frames, iters=iters,
                per_problem_iter_per_s=iters / dt, median_s=dt,
                all_runs=[iters / t for t in ts], rep_iters=rep_iters,
                cost=float(r.cost), k1_launches=launches,
                k1_per_iteration=launches / (iters + sum(rep_iters)))


def child(spec: dict) -> int:
    """The child's body: ``spec["dir"]`` first on ``sys.path`` (in place of
    this script's directory), its package checked, one measurement."""
    tree = os.path.realpath(spec["dir"])
    sys.path[0:1] = [tree]
    import omniswarm_torch

    pkg = os.path.realpath(os.path.dirname(omniswarm_torch.__file__))
    if os.path.commonpath([pkg, tree]) != tree:
        print(f"drift_probe: omniswarm_torch resolves to {pkg}, outside "
              f"{tree}; refusing to measure", file=sys.stderr, flush=True)
        return REFUSED
    row = measure(spec["device"], spec["drones"], spec["frames"],
                  spec["reps"])
    print(json.dumps(dict(tree=tree, **row)), flush=True)
    return 0


def run_child(tree: str, *, device: str, drones: int, frames: int,
              reps: int, timeout_s: float = 900.0
              ) -> subprocess.CompletedProcess:
    """This file run as a script on ``tree`` (killed at ``timeout_s``), in
    ``tree`` as its working directory."""
    tree = os.path.realpath(tree)
    spec = dict(dir=tree, device=device, drones=drones, frames=frames,
                reps=reps)
    return subprocess.run(
        [sys.executable, os.path.realpath(__file__), "--child",
         json.dumps(spec)], cwd=tree, capture_output=True, text=True,
        timeout=timeout_s)


def probe(other: str, *, device="cuda", order=ORDER,
          drones: int = HEADLINE["drones"], frames: int = HEADLINE["frames"],
          reps: int = HEADLINE["reps"], timeout_s: float = 900.0) -> dict:
    """The measurements in ``order`` ("other" is ``other``, "this" this
    tree) and their summary; each row is printed as it comes."""
    from omniswarm_torch.benchutil import card
    from omniswarm_torch.core.device import resolve_device

    dev = resolve_device(device)
    name = card(dev)
    rows = []
    for which in order:
        tree = other if which == "other" else THIS_TREE
        proc = run_child(tree, device=str(dev), drones=drones,
                         frames=frames, reps=reps, timeout_s=timeout_s)
        if proc.returncode:
            raise RuntimeError(f"drift_probe on {tree}: exit "
                               f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        row = dict(which=which, **json.loads(proc.stdout.splitlines()[-1]),
                   card=name)
        print(json.dumps(row), flush=True)
        rows.append(row)

    def mean_rate(which):
        got = [r["per_problem_iter_per_s"] for r in rows
               if r["which"] == which]
        return statistics.fmean(got) if got else None

    this, that = mean_rate("this"), mean_rate("other")
    summary = dict(
        summary=True, other=os.path.realpath(other), this=THIS_TREE,
        order=list(order), this_iter_per_s=this, other_iter_per_s=that,
        this_over_other=this / that if this and that else None,
        iters_equal=len({r["iters"] for r in rows}) == 1,
        costs_equal=len({r["cost"] for r in rows}) == 1,
        k1_launches={w: [r["k1_launches"] for r in rows if r["which"] == w]
                     for w in ("other", "this")},
        card=name)
    print(json.dumps(summary), flush=True)
    return dict(rows=rows, summary=summary)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.drift_probe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", help="the other checkout (its root)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from omniswarm_torch.core.device import resolve_device

    resolve_device(args.device)
    if not os.path.isdir(args.dir):
        ap.error(f"{args.dir} is not a directory")
    return probe(args.dir, device=args.device)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(json.loads(sys.argv[2])))
    main()
