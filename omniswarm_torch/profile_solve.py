"""Where the time of the flagship LM solve and of the front-end goes on the GPU.

    python -m omniswarm_torch.profile_solve [--frames 100 1024] [--frontend]

Builds the seed-0, 5-drone problem, runs one warm-up solve, then traces one
solve of 20 LM iterations with ``torch.profiler`` (CPU and
CUDA activities). Prints one JSON line: wall ms per iteration (host clock,
synchronised), device-busy ms per iteration (the union of kernel intervals
in the trace), the device's idle share, K1's (``fused_level_kernel``,
every instantiation) device ms and launches per iteration, and the kernels
that took the most device time with their launch counts. Needs a CUDA card.

``--frontend`` traces the front-end path of ``frontend_entry`` instead (5
drones x 15 keyframe steps of 40 views at 400 x 208, rendered before the
trace, after a 2-step warm-up): wall and device-busy ms per step, the idle
share, device ms per stage (the ``frontend/*`` profiler ranges: SuperPoint
convolutions, keypoints with K2 and the sort, descriptor sampling and PCA,
NetVLAD, matching, triangulation, retrieval with K3), and the top kernels.
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
    n = res.iterations
    busy_us, launches, top_kernels, per_kernel = _kernel_table(
        prof, n, top, "iteration")
    k1 = [v for name, v in per_kernel.items() if "fused_level_kernel" in name]
    return {
        "card": _card(), "frames": frames, "iterations": n,
        "cost": float(res.cost),
        "wall_ms_per_iteration": wall_s * 1e3 / n,
        "device_busy_ms_per_iteration": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches_per_iteration": launches / n,
        "k1_fused_level_ms_per_iteration": sum(us for us, _ in k1) / 1e3 / n,
        "k1_fused_level_launches_per_iteration": sum(c for _, c in k1) / n,
        "top_kernels": top_kernels,
        "note": "the traced solve includes its cold seed factorization",
    }


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _device_events(prof):
    """(kernels, annotations): the trace's device events, split into the
    kernels and memory operations and the GPU spans of ``record_function``
    ranges."""
    kernels, annotations = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        annotation = evt.is_user_annotation or evt.name.startswith(
            "frontend/")
        (annotations if annotation else kernels).append(evt)
    return kernels, annotations


def _kernel_table(prof, n: int, top: int, unit: str):
    """(busy us, kernel launches, top kernels per ``unit``, us and launches
    by kernel name) of a trace's device kernels over ``n`` units."""
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in _device_events(prof)[0]:
        start, end = evt.time_range.start, evt.time_range.end
        intervals.append((start, end))
        per_kernel[evt.name][0] += end - start
        per_kernel[evt.name][1] += 1
    busy_us = _busy_us(intervals)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return busy_us, len(intervals), [
        {"name": name[:120], f"ms_per_{unit}": us / 1e3 / n,
         f"launches_per_{unit}": cnt / n, "share_of_busy": us / busy_us}
        for name, (us, cnt) in kernels], per_kernel


def profile_frontend(top: int = 15) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from omniswarm_torch.frontend_entry import BASELINE, prepare, run_steps
    from omniswarm_torch.swarm.loop_cam import OmniLoopCam

    dev = resolve_device("cuda")
    prep = prepare()
    cam = OmniLoopCam(params=prep.fp, intrinsics=prep.intr,
                      baseline=BASELINE, device=dev)
    run_steps(cam, prep.fp, prep.steps[:2])        # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_steps(cam, prep.fp, prep.steps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    n = len(prep.steps)
    busy_us, launches, top_kernels, per_kernel = _kernel_table(prof, n, top,
                                                               "step")
    # a kernel belongs to the frontend/* range whose GPU span holds it
    kernels, annotations = _device_events(prof)
    spans = sorted((a.time_range.start, a.time_range.end, a.name)
                   for a in annotations if a.name.startswith("frontend/"))
    stages = collections.defaultdict(float)
    for k in kernels:
        start, end = k.time_range.start, k.time_range.end
        name = next((nm for s0, e0, nm in spans if s0 <= start < e0),
                    "outside any stage")
        stages[name] += end - start
    named = {"K2 grid_nms_kernel": ("grid_nms_kernel",),
             "K3 retrieval_kernel": ("retrieval_kernel",),
             "sort kernels (top-K)": ("sort", "Sort")}
    return {
        "card": _card(), "path": "frontend", "steps": n,
        "views_per_step": 4 * prep.data.gt.shape[1],
        "wall_ms_per_step": wall_s * 1e3 / n,
        "traced_extract_ms_per_step": float(out[4].mean()),
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches_per_step": launches / n,
        "stage_device_ms_per_step": {
            k: v / 1e3 / n for k, v in sorted(stages.items())},
        "kernel_device_ms_per_step": {
            label: sum(us for name, (us, _c) in per_kernel.items()
                       if any(p in name for p in pats)) / 1e3 / n
            for label, pats in named.items()},
        "top_kernels": top_kernels,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[100])
    ap.add_argument("--frontend", action="store_true",
                    help="profile the front-end path instead of the solve")
    args = ap.parse_args()
    if args.frontend:
        print(json.dumps(profile_frontend()), flush=True)
        return
    for frames in args.frames:
        print(json.dumps(profile(frames)), flush=True)


if __name__ == "__main__":
    main()
