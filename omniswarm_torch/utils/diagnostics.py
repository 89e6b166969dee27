"""Crash diagnostics — the backward.hpp analog.

A copy of ``omniswarm_tpu/utils/diagnostics.py``. The reference vendors
backward-cpp and installs signal handlers in every binary so crashes print
a full stack trace (swarm_localization_node.cpp:32-37 etc.). The Python
equivalent: faulthandler on fatal signals, plus an optional watchdog that
dumps every thread's stack if the process seems hung (a device call that
never returns, a solve thread that deadlocks against the ingest lock).
"""
from __future__ import annotations

import faulthandler
import signal
import sys
import threading


def install_crash_handler(*, also_usr1: bool = True) -> None:
    """Dump tracebacks on SIGSEGV/SIGFPE/SIGABRT/SIGBUS (+ SIGUSR1 on
    demand, like `kill -USR1 <pid>` for a live stack dump)."""
    faulthandler.enable(file=sys.stderr, all_threads=True)
    if also_usr1 and hasattr(signal, "SIGUSR1"):
        try:
            faulthandler.register(signal.SIGUSR1, file=sys.stderr,
                                  all_threads=True, chain=False)
        except (ValueError, RuntimeError):
            pass  # not on main thread / unsupported platform


def install_hang_watchdog(timeout_s: float = 60.0) -> "threading.Timer":
    """Dump all stacks if not cancelled within timeout_s (one-shot).

    Call around long device operations:
        w = install_hang_watchdog(120); ...; w.cancel()
    """
    def dump():
        sys.stderr.write(
            f"[diagnostics] watchdog fired after {timeout_s}s — "
            "dumping all thread stacks\n")
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)

    timer = threading.Timer(timeout_s, dump)
    timer.daemon = True
    timer.start()
    return timer
