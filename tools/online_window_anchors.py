#!/usr/bin/env python3
"""Reference anchors for the online-window phase (14a) of ``chip_smoke.py``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/online_window_anchors.py \
        [--frames 1024] [--loops 2000] [--solves 3]

Drives the JAX package's estimator on the CPU through
``tools/online_window_bench.py``'s own ``build_estimator`` and
``ingest_tick`` (its session, untimed): the first solve of the
1,024-keyframe window with 2,000 loops, then ``--solves`` live solves,
each after an ingest tick. Prints one JSON object to paste into
``chip_smoke.py``'s ``ONLINE_ANCHORS``: per solve the record of
``omniswarm_torch.online_window.solve_record`` (window frame times as
[first, last] runs, PCM inlier sets per drone pair, iterations, cost,
``finish_init``). Progress, wall time and peak RSS go to stderr.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    from omniswarm_torch.online_window import solve_record

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--loops", type=int, default=2000)
    ap.add_argument("--solves", type=int, default=3)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "online_window_bench", ROOT / "tools" / "online_window_bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    t0 = time.perf_counter()

    def log(msg):
        print(f"{msg} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
              flush=True)

    est, rng, pose = ref.build_estimator(args.frames, args.loops)
    log("built")
    solves = [solve_record(est, est.solve())]
    log(f"first solve {solves[-1]['iterations']} iterations cost "
        f"{solves[-1]['cost']}")
    t_now = 100.0 + args.frames
    for k in range(args.solves):
        t_now += 1.0
        ref.ingest_tick(est, rng, pose, t_now)
        prep = est.prepare_solve()
        if prep.get("refused") or prep["dense_graph"] is None:
            raise RuntimeError(f"live solve {k}: refused or fell back")
        solves.append(solve_record(
            est, est.finalize_solve(prep, est.execute_solve(prep))))
        log(f"live solve {k} {solves[-1]['iterations']} iterations cost "
            f"{solves[-1]['cost']}")
    print(json.dumps(dict(frames=args.frames, loops=args.loops,
                          solves=solves)))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    log(f"done, peak RSS {rss:.2f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
