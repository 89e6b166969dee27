"""Reduction of a ``torch.profiler`` trace to the benchmark's readings.

``busy_us``, ``device_events`` and the range attribution in ``summarize``
are copies of the port's ``profile_solve.py`` (``_busy_us``,
``_device_events`` and the stage loop of ``profile_frontend``), frozen
here so that a change to the program cannot change how its trace is read.

``summarize`` turns a finished profile into a ``Trace``: every device
kernel (name, start, end, in microseconds on the profiler's clock), the
device spans of the program's ``record_function`` ranges, the busy time (the
union of kernel intervals), and the host's own ops, from which the idle
gaps of the device are labelled by what the host was doing.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, NamedTuple, Tuple

RANGE_PREFIXES = ("frontend/", "detector/")
# CUDA runtime and driver calls: the host op that made them is the label
RUNTIME_PREFIXES = ("cuda", "cu", "Activity Buffer")
COPY_PREFIXES = ("Memcpy", "Memset")


def busy_us(intervals) -> float:
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


def device_events(prof):
    """(kernels, annotations): the trace's device events, split into the
    kernels and memory operations and the GPU spans of ``record_function``
    ranges."""
    import torch

    kernels, annotations = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        annotation = evt.is_user_annotation or evt.name.startswith(
            RANGE_PREFIXES)
        (annotations if annotation else kernels).append(evt)
    return kernels, annotations


class Trace(NamedTuple):
    kernels: List[Tuple[str, float, float]]      # (name, start, end) us
    ranges: List[Tuple[str, float, float]]       # device spans of ranges
    busy_us: float
    window_s: float                              # host clock, traced window
    idle_by_host: List[Tuple[str, float]]        # (host op, idle s)

    def kernel_us(self, *patterns) -> Tuple[float, int]:
        """(device us, launches) of the kernels whose name holds any of
        ``patterns``."""
        hits = [e - s for n, s, e in self.kernels
                if any(p in n for p in patterns)]
        return sum(hits), len(hits)

    def by_range(self) -> Dict[str, float]:
        """Device us of the kernels by the innermost range whose device
        span holds each kernel's start."""
        spans = sorted(self.ranges, key=lambda r: (r[1], -r[2]))
        out = collections.defaultdict(float)
        for name, start, end in self.kernels:
            inner = None
            for nm, s0, e0 in spans:
                if s0 <= start < e0:
                    inner = nm          # later-starting spans are inner
                elif s0 > start:
                    break
            out[inner or "outside any range"] += end - start
        return dict(out)

    def top_kernels(self, n: int = 10) -> List[Tuple[str, float]]:
        per = collections.defaultdict(float)
        for name, s, e in self.kernels:
            per[name] += e - s
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]


def summarize(prof, window_s: float) -> Trace:
    """The ``Trace`` of a finished profile whose window lasted
    ``window_s`` seconds on the host clock."""
    import torch

    kern, ann = device_events(prof)
    kernels = [(k.name, k.time_range.start, k.time_range.end) for k in kern]
    ranges = [(a.name, a.time_range.start, a.time_range.end) for a in ann
              if a.name.startswith(RANGE_PREFIXES)]
    busy = busy_us([(s, e) for _, s, e in kernels])
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and not e.name.startswith(RUNTIME_PREFIXES)]
    return Trace(kernels, ranges, busy, window_s,
                 _idle_by_host(kernels, host))


def _idle_by_host(kernels, host, n: int = 10):
    """Device idle time between kernels, summed by the innermost host op
    that was running at each gap's midpoint; the ``n`` largest sums."""
    ivs = sorted((s, e) for _, s, e in kernels)
    gaps, end = [], None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host = sorted(host, key=lambda h: (h[1], -h[2]))
    starts = [h[1] for h in host]
    per = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "host between ops"
        k = bisect.bisect_right(starts, mid)
        best = None
        # the innermost op holding mid: the latest-starting one that holds it
        for name, s, e in reversed(host[max(0, k - 400):k]):
            if s <= mid < e:
                best = name
                break
        if best is not None:
            label = best
        per[label] += (g1 - g0) / 1e6
    return [[name[:160], sec] for name, sec in
            sorted(per.items(), key=lambda kv: -kv[1])[:n]]
