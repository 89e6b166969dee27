"""Where the time of the flagship LM solve and of the front-end goes on the GPU.

    python -m omniswarm_torch.profile_solve [--frames 100 1024] [--sweep]
                                            [--frontend [--chrome-trace PATH]]
                                            [--estimator] [--demo]

Builds the seed-0, 5-drone problem (with ``--sweep`` the window-scale
sweep's: seed 1, ``loop_every=128``), runs one warm-up solve, then traces
one solve of 20 LM iterations with ``torch.profiler`` (CPU and
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
NetVLAD, matching, triangulation, retrieval with K3, and the copies of the
views and outputs in ``frontend/upload`` and ``frontend/download``), the
device's idle ms per step by what the host was doing, and the top kernels.
An idle gap takes the name of the innermost host op at its midpoint, as the
benchmark labels it: the host phases ``frontend/stage`` (gathering and
stacking the views), ``frontend/merge`` (the casts and the per-drone
merge), ``placedb/query`` and ``placedb/add``, or a torch op, or ``host
between ops``. ``--chrome-trace PATH`` writes the traced timeline there.

``--estimator`` runs ``estimator_entry``'s session twice, held
(``acpt_cost=1000``) and deployed (100), and traces the last solve of each:
a warm solve of the full window (PCG at F=104) and a 4-lane multi-init
re-init. Per traced solve: wall, host-build and device ms (telemetry),
iterations, device-busy ms, the idle share, kernel launches per iteration,
K1's device ms and launches, and the top kernels.

``--demo`` runs ``demo_entry.image_demo_entry`` (5 drones x 30 frames,
the views rendered first) and traces its last 3 keyframe steps (frames
24-29: 3 extractions and about 30 detector ticks): the ticks' lanes and
untraced medians (tick ms, keyframe latency, views/s over the whole run),
device ms per tick by stage (the ``detector/*`` ranges: retrieval with the
ring inserts and the candidate merge, verification, the download), host
ms per call of each range (``detector/host_gates`` is the host's
acceptance walk), the window's other device time by ``frontend/*`` stage,
the idle share, and the kernels that take most of a tick.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import time

import torch

from omniswarm_torch import sim
from omniswarm_torch.benchutil import card
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


def profile(frames: int, top: int = 12, seed: int = 0,
            loop_every: int = 5) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = resolve_device("cuda")
    data = sim.generate(sim.SimParams(num_drones=5, num_frames=frames,
                                      seed=seed, loop_every=loop_every))
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
        "card": card("cuda"), "frames": frames, "seed": seed,
        "loops": len(data.loops), "iterations": n,
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


def _device_events(prof):
    """(kernels, annotations): the trace's device events, split into the
    kernels and memory operations and the GPU spans of ``record_function``
    ranges."""
    kernels, annotations = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        annotation = evt.is_user_annotation or evt.name.startswith(
            ("frontend/", "detector/", "placedb/"))
        (annotations if annotation else kernels).append(evt)
    return kernels, annotations


# CUDA runtime and driver calls: the host op that made them is the label
_RUNTIME_PREFIXES = ("cuda", "cu", "Activity Buffer")


def _idle_by_host(kernels, host):
    """Device idle us between the ``(start, end)`` intervals ``kernels``,
    summed by the innermost of the ``(name, start, end)`` host ops
    ``host`` that holds each gap's midpoint (``host between ops`` where
    none does; of the 400 ops that started last before it), largest
    first: the benchmark's rule, without its cut to the 10 largest."""
    gaps, end = [], None
    for s, e in sorted(kernels):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host = sorted(host, key=lambda h: (h[1], -h[2]))
    starts = [h[1] for h in host]
    per = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        k = bisect.bisect_right(starts, mid)
        label = next((name for name, s, e in reversed(host[max(0, k - 400):k])
                      if s <= mid < e), "host between ops")
        per[label] += g1 - g0
    return sorted(per.items(), key=lambda kv: -kv[1])


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


def profile_frontend(top: int = 15, chrome_trace=None) -> dict:
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
    cpu = torch.autograd.DeviceType.CPU
    idle = _idle_by_host(
        [(k.time_range.start, k.time_range.end) for k in kernels],
        [(e.name, e.time_range.start, e.time_range.end)
         for e in prof.events()
         if e.device_type == cpu and not e.name.startswith(_RUNTIME_PREFIXES)])
    if chrome_trace:
        prof.export_chrome_trace(str(chrome_trace))
    named = {"K2 grid_nms_kernel": ("grid_nms_kernel",),
             "K3 retrieval_kernel": ("retrieval_kernel",),
             "sort kernels (top-K)": ("sort", "Sort")}
    return {
        "card": card("cuda"), "path": "frontend", "steps": n,
        "views_per_step": 4 * prep.data.gt.shape[1],
        "wall_ms_per_step": wall_s * 1e3 / n,
        "traced_extract_ms_per_step": float(out[4].mean()),
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches_per_step": launches / n,
        "stage_device_ms_per_step": {
            k: v / 1e3 / n for k, v in sorted(stages.items())},
        "idle_ms_per_step_by_host_op": {k: v / 1e3 / n for k, v in idle},
        "kernel_device_ms_per_step": {
            label: sum(us for name, (us, _c) in per_kernel.items()
                       if any(p in name for p in pats)) / 1e3 / n
            for label, pats in named.items()},
        "top_kernels": top_kernels,
    }


def profile_estimator(top: int = 12) -> list:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from omniswarm_torch.estimator_entry import SESSION, estimator_entry

    resolve_device("cuda")
    estimator_entry(acpt_cost=1000.0)                # warm-up
    out = []
    for name, acpt in (("held, warm", 1000.0), ("deployed, multi-init",
                                                 100.0)):
        last = SESSION["num_frames"] // 10 - 1
        traced = {}

        @contextlib.contextmanager
        def around(i):
            if i != last:
                yield
                return
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                traced["wall_s"] = time.perf_counter() - t0
            traced["prof"] = prof

        run = estimator_entry(acpt_cost=acpt, around_solve=around)
        s = run["solves"][last]
        n = s["iterations"] * (s["lanes"] or 1)
        busy_us, launches, top_kernels, per_kernel = _kernel_table(
            traced["prof"], n, top, "lane_iteration")
        k1 = [v for nm, v in per_kernel.items() if "fused_level_kernel" in nm]
        wall_s = traced["wall_s"]
        out.append({
            "card": card("cuda"), "path": f"estimator {name}", "solve": last,
            "F": s["F"], "linear": s["linear"], "pack": s["pack"],
            "lanes": s["lanes"], "iterations": s["iterations"],
            "cost": s["cost"], "wall_ms": wall_s * 1e3,
            "host_build_ms": s["host_ms"], "device_ms": s["device_ms"],
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "kernel_launches_per_lane_iteration": launches / n,
            "k1_fused_level_ms": sum(us for us, _ in k1) / 1e3,
            "k1_fused_level_launches": sum(c for _, c in k1),
            "top_kernels": top_kernels,
        })
    return out


DEMO_TRACED_FRAMES = (24, 29)    # the last 3 keyframe steps of 15


def profile_demo(top: int = 12) -> dict:
    """The image demo (``demo_entry.image_demo_entry``, 5 drones x 30
    frames) with its last 3 keyframe steps (frames 24-29) under the
    profiler: where a keyframe's latency goes on the card. Rendering
    happens before the run, the final solves after the window."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from omniswarm_torch.demo_entry import image_demo_entry
    from omniswarm_torch.frontend_entry import prepare

    resolve_device("cuda")
    prep = prepare()
    first, last = DEMO_TRACED_FRAMES
    prof = torch_profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    window = {}

    @contextlib.contextmanager
    def around(k):
        if k == first:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        yield
        if k == last:
            torch.cuda.synchronize()
            window["wall_s"] = time.perf_counter() - window["t0"]
            prof.stop()

    res = image_demo_entry(prep=prep, around_frame=around)
    wall_s = window["wall_s"]
    kernels, annotations = _device_events(prof)
    spans = sorted((a.time_range.start, a.time_range.end, a.name)
                   for a in annotations
                   if a.name.startswith(("frontend/", "detector/")))
    stages = collections.defaultdict(float)
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for k in kernels:
        start, end = k.time_range.start, k.time_range.end
        intervals.append((start, end))
        name = next((nm for s0, e0, nm in spans if s0 <= start < e0),
                    "outside the ranges")
        stages[name] += end - start
        if name.startswith("detector/"):
            per_kernel[k.name][0] += end - start
            per_kernel[k.name][1] += 1
    busy_us = _busy_us(intervals)
    cpu = torch.autograd.DeviceType.CPU
    host = {e.key: (e.cpu_time_total / 1e3 / max(e.count, 1), e.count)
            for e in prof.key_averages()
            if e.key.startswith("detector/") and e.device_type == cpu}
    ticks = host["detector/retrieval"][1]
    top_kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "card": card("cuda"), "path": "image demo",
        "traced_frames": [first, last],
        "traced_ticks": ticks, "traced_wall_ms": wall_s * 1e3,
        "verify_lanes_per_tick": res["verify_lanes_per_tick"],
        "tick_ms_median": res["detector_tick_ms_median"],
        "keyframe_latency_ms_median": res["keyframe_latency_ms"],
        "views_per_s": res["frontend_views_per_s"],
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "tick_stage_device_ms": {k: v / 1e3 / ticks for k, v in
                                 stages.items() if k.startswith("detector/")},
        "tick_stage_host_ms": {k: v[0] for k, v in host.items()},
        "window_stage_device_ms": {k: v / 1e3 for k, v in stages.items()
                                   if not k.startswith("detector/")},
        "top_tick_kernels": [
            {"name": name[:120], "ms_per_tick": us / 1e3 / ticks,
             "launches_per_tick": cnt / ticks}
            for name, (us, cnt) in top_kernels],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[100])
    ap.add_argument("--sweep", action="store_true",
                    help="the window-scale sweep's problem (seed 1, "
                         "loop_every=128)")
    ap.add_argument("--frontend", action="store_true",
                    help="profile the front-end path instead of the solve")
    ap.add_argument("--chrome-trace", metavar="PATH",
                    help="with --frontend: write the traced timeline to PATH "
                         "(Chrome trace JSON)")
    ap.add_argument("--estimator", action="store_true",
                    help="profile two estimator solves instead")
    ap.add_argument("--demo", action="store_true",
                    help="profile the image demo's keyframe ticks instead")
    args = ap.parse_args()
    if args.demo:
        print(json.dumps(profile_demo()), flush=True)
        return
    if args.frontend:
        print(json.dumps(profile_frontend(chrome_trace=args.chrome_trace)),
              flush=True)
        return
    if args.estimator:
        for row in profile_estimator():
            print(json.dumps(row), flush=True)
        return
    problem = dict(seed=1, loop_every=128) if args.sweep else {}
    for frames in args.frames:
        print(json.dumps(profile(frames, **problem)), flush=True)


if __name__ == "__main__":
    main()
