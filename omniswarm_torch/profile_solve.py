"""Where the time of the flagship LM solve goes on the GPU.

    python -m omniswarm_torch.profile_solve [--frames 100 1024]

Builds the seed-0, 5-drone problem, runs one warm-up solve, then traces one
solve of 20 LM iterations with ``torch.profiler`` (CPU and
CUDA activities). Prints one JSON line: wall ms per iteration (host clock,
synchronised), device-busy ms per iteration (the union of kernel intervals
in the trace), the device's idle share, and the kernels that took the most
device time with their launch counts. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from omniswarm_torch import sim
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.solver.dense import dense_graph_from_sim, lm_solve_bt


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


ITERATIONS = 20


def profile(frames: int, top: int = 12) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = resolve_device("cuda")
    data = sim.generate(sim.SimParams(num_drones=5, num_frames=frames,
                                      seed=0))
    graph = dense_graph_from_sim(data)
    kw = dict(device=dev, max_iterations=ITERATIONS, function_tolerance=0.0)
    lm_solve_bt(graph, data.vio, **kw)             # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = lm_solve_bt(graph, data.vio, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        intervals.append((start, end))
        per_kernel[evt.name][0] += end - start
        per_kernel[evt.name][1] += 1
    busy_us = _busy_us(intervals)
    n = res.iterations
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return {
        "card": card, "frames": frames, "iterations": n,
        "cost": float(res.cost),
        "wall_ms_per_iteration": wall_s * 1e3 / n,
        "device_busy_ms_per_iteration": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches_per_iteration": len(intervals) / n,
        "top_kernels": [
            {"name": name[:120], "ms_per_iteration": us / 1e3 / n,
             "launches_per_iteration": cnt / n,
             "share_of_busy": us / busy_us}
            for name, (us, cnt) in kernels],
        "note": "the traced solve includes its cold seed factorization",
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[100])
    args = ap.parse_args()
    for frames in args.frames:
        print(json.dumps(profile(frames)), flush=True)


if __name__ == "__main__":
    main()
