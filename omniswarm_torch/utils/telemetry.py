"""Tracing/profiling utilities — the reference's TicToc culture, structured.

A copy of ``omniswarm_tpu/utils/telemetry.py``. The reference sprinkles
wall-clock scopes with running averages through every hot path (solver solve
time solver.cpp:954-957, outlier rejection :1650-1657, front-end keyframe
cost loop_cam.cpp:205-207, loop-detection time loop_detector.cpp:134-136,
per-message byte accounting loop_net.cpp:95-100). This module provides the
same capability as a global registry of named timers/counters with running
averages, plus JSON export for dashboards.

On-device timing caveat: CUDA launches are asynchronous — ``scope``
synchronizes the device of an optional tensor given as ``block_on`` to
measure real device time.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class TimerStat:
    count: int = 0
    total_ms: float = 0.0
    last_ms: float = 0.0
    max_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    def add(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.last_ms = ms
        self.max_ms = max(self.max_ms, ms)


class Telemetry:
    def __init__(self):
        self._timers: Dict[str, TimerStat] = {}
        self._counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None):
        """Time a scope; pass a tensor as ``block_on`` to measure device
        completion, not dispatch."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._timers.setdefault(name, TimerStat()).add(ms)

    def record_ms(self, name: str, ms: float) -> None:
        with self._lock:
            self._timers.setdefault(name, TimerStat()).add(ms)

    def count(self, name: str, value: float = 1.0) -> None:
        """Accumulate a counter (e.g. bytes sent, loops accepted)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def timer(self, name: str) -> TimerStat:
        return self._timers.get(name, TimerStat())

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    def report(self) -> Dict:
        with self._lock:
            return {
                "timers": {
                    k: {"count": v.count, "avg_ms": round(v.avg_ms, 3),
                        "last_ms": round(v.last_ms, 3),
                        "max_ms": round(v.max_ms, 3)}
                    for k, v in self._timers.items()
                },
                "counters": dict(self._counters),
            }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)

    def summary(self) -> str:
        rep = self.report()
        lines = []
        for k, v in sorted(rep["timers"].items()):
            lines.append(f"{k:40s} n={v['count']:6d} avg={v['avg_ms']:8.2f}ms"
                         f" last={v['last_ms']:8.2f}ms max={v['max_ms']:8.2f}ms")
        for k, v in sorted(rep["counters"].items()):
            lines.append(f"{k:40s} total={v:.0f}")
        return "\n".join(lines)


GLOBAL = Telemetry()
