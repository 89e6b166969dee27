"""The readings that set the ``rgbd_keyframes`` cell's limits: the program
on many seeds, and the control (the reference's RGB-D step and retrieval
put in the program's place and run in TF32, the precision below the
configuration's float32 with TF32 off) on the same set-up.

    python3 -m benchmark.controls.rgbd_keyframes \
        --workload swarm5_rgbd640.rgbd_keyframes --seeds 11 12 13 \
        [--units 12] [--control-seeds 3]

For each seed, in one process: the traffic ``Driver``'s set-up (its warm
steps included), ``--units`` steps of the program, judged by
``Driver.check`` (the lower readings); on the first ``--control-seeds``
seeds the same steps by ``reference.rgbd`` under TF32 (every drone's view
through ``step``, retrieval by ``reference.frontend.top1`` against the
database as seeded and as the control fills it), judged by the same check
(the upper readings). One JSON line a seed, then one with the worst of
each. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import run
from benchmark.controls.keyframes import tf32
from benchmark.reference import frontend as ref
from benchmark.reference import rgbd


def control_units(drv, units: int) -> None:
    """``units`` steps of the reference in TF32 in the program's place,
    recorded as ``Driver`` records the program's, from its first step."""
    sp = ref.load_weights(drv.root / drv.fe["superpoint_weights"], drv.device)
    nv = ref.load_weights(drv.root / drv.fe["netvlad_weights"], drv.device)
    db = drv.filler()
    N = db.shape[0]
    drone = torch.tensor([i % drv.D for i in range(N)], device=drv.device)
    frame = torch.tensor([-1000 * N + i for i in range(N)],
                         device=drv.device)
    cursor = N
    drv.outputs = []
    for s in range(units):
        views = drv.pool[s % len(drv.pool)]
        with tf32():
            out = rgbd.step(sp, nv, drv.fe, np.stack([g for g, _ in views]),
                            np.stack([d for _, d in views]), drv.device,
                            drv.depth_scale)
            q = torch.tensor(out.gdesc, device=drv.device)
            qf = drv.kf_every * s
            qd = torch.arange(drv.D, device=drv.device)[:, None]
            usable = ~((drone[None] == qd)
                       & ((frame[None] - qf).abs()
                          < drv.fp.match_index_dist))
            idx, sims = ref.top1(db, usable, q)
        for d in range(drv.D):
            slot = cursor % N
            db[slot], drone[slot], frame[slot] = q[d], d, qf
            cursor += 1
        drv.outputs.append((s, [
            (out.xy[d], out.desc[d], out.ok[d], out.gdesc[d], out.pts[d], d)
            for d in range(drv.D)], out.kp_valid, idx.cpu().numpy(),
            sims.cpu().numpy()))


def seed_row(c, seed: int, units: int, control: bool, device) -> dict:
    drv_mod = run.load_module(c.driver, "benchmark_driver_rgbd_keyframes")
    t0 = time.perf_counter()
    drv = drv_mod.Driver(c.config, c.traffic, seed, device)
    row = {"seed": seed, "setup_s": time.perf_counter() - t0}
    for _ in range(units):
        drv.unit()
    drv.release()
    row["program"] = drv.check()
    if control:
        control_units(drv, units + int(c.traffic["warm_steps"]))
        row["control_tf32"] = drv.check()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    c = run.cell(run.ROOT, args.workload)
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": run.card(0)}), flush=True)
    rows = []
    for i, seed in enumerate(args.seeds):
        rows.append(seed_row(c, seed, args.units, i < args.control_seeds,
                             dev))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for key, pick in (("program", max), ("control_tf32", min)):
        got = [r[key] for r in rows if key in r]
        if got:
            summary[key] = {n: pick(g[n] for g in got) for n in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
