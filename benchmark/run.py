"""One run of one cell of the benchmark of the port (``omniswarm_torch``).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. Everything is found by name from ``BENCHMARK.json``:
the cell's configuration file (``configs[].file``), its traffic mix
``benchmark/traffic/<traffic>.json`` (which names its driver,
``benchmark/drivers/<driver>.py``), its limits
``benchmark/limits/<cell>.json`` and one reader per metric,
``benchmark/metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files and entries; no file here changes.

A run: set-up (the traffic's ``Driver`` builds its inputs from ``--seed`` and warms up
every shape; ``setup_s`` counts from the start of this process), then
either the measured window (``--trace 0``: whole units until ``--seconds``
have passed, host clock, each unit synchronised) or the traced window
(``--trace 1``: ``traced_units`` units under ``torch.profiler``). Then the
peak device memory is read, the program's state is freed, the ``Driver``'s
reference judges every unit's output against the cell's limits, and the
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks`` (each number compared, with its limit).
The checks are also the last lines of standard error.

Without a CUDA card (or with fewer than the cell asks for), or if the
process holds JAX or the JAX package once the window has closed, the run
exits non-zero and prints no result.
"""
from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "omniswarm_tpu")


class CellError(RuntimeError):
    """The cell cannot run here; the run exits without a result."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one(items, name, what):
    hits = [x for x in items if x["name"] == name]
    if len(hits) != 1:
        raise CellError(f"{what} {name!r}: {len(hits)} entries in "
                        f"BENCHMARK.json")
    return hits[0]


def cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell ``workload`` as the files under ``root`` define it."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = _one(spec["workloads"], workload, "workload")
    conf = _one(spec["configs"], wl["config"], "configuration")
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{wl['traffic']}.json")
                         .read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        name=workload, chips=wl["chips"], root=root,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=traffic,
        driver=bench / "drivers" / f"{traffic['driver']}.py",
        limits=json.loads((bench / "limits" / f"{workload}.json")
                          .read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
        readers={m["name"]: bench / "metrics" / f"{m['name']}.py"
                 for m in spec["end_to_end"] + spec["per_layer"]
                 if applies(m)})


def card(index: int = 0) -> dict:
    """The card's name (as torch names it) and power limit (nvidia-smi)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return {"kind": torch.cuda.get_device_name(index),
            "power_limit": out.stdout.strip() or out.stderr.strip()}


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(c: SimpleNamespace, seed: int, seconds: float, trace: bool,
            device) -> dict:
    """Set-up, window, reference check and metrics of one run of cell
    ``c``; returns the result line as a dict (key order as printed)."""
    import torch

    drv_mod = load_module(c.driver, f"benchmark_driver_{c.driver.stem}")
    drv = drv_mod.Driver(c.config, c.traffic, seed, device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    unit_s, counts, prof_trace = [], {}, None

    def one_unit():
        t0 = time.perf_counter()
        got = drv.unit()
        torch.cuda.synchronize(device)
        unit_s.append(time.perf_counter() - t0)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v

    if not trace:
        t0 = time.perf_counter()
        while True:
            one_unit()
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    else:
        from torch.profiler import ProfilerActivity, profile

        from benchmark.frozen.trace import summarize

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(int(c.traffic["traced_units"])):
                one_unit()
            window_s = time.perf_counter() - t0
        prof_trace = summarize(prof, window_s)
        del prof
    peak = torch.cuda.max_memory_allocated(device)
    found = forbidden_modules()
    if found:
        raise CellError(f"the process holds {found} after the window")

    drv.release()
    readings = drv.check()
    checks = {name: {"value": readings.get(name, math.inf),
                     "limit": limit} for name, limit in c.limits.items()}
    correct = bool(checks) and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in checks.values())

    rec = SimpleNamespace(workload=c.name, config=c.config,
                          traffic=c.traffic, setup_s=setup_s,
                          window_s=window_s, unit_s=unit_s, counts=counts,
                          trace=prof_trace)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        reader = load_module(c.readers[m["name"]],
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {"platform": "gpu", **card(device.index or 0),
                   "count": c.chips, "memory_peak_bytes": int(peak)}
    if trace:
        device_info.update(busy_s=prof_trace.busy_us / 1e6,
                           window_s=prof_trace.window_s)
    result = {"correct": correct, "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": prof_trace.top_kernels(10),
                               "idle_gaps": prof_trace.idle_by_host}
    result["checks"] = checks
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    try:
        c = cell(ROOT, args.workload)
        if not torch.cuda.is_available():
            raise CellError("no CUDA card: the benchmark runs only on one")
        if torch.cuda.device_count() < c.chips:
            raise CellError(f"{torch.cuda.device_count()} CUDA cards, the "
                            f"cell asks for {c.chips}")
        result = measure(c, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0))
    except CellError as err:
        print(f"benchmark: {err}", file=sys.stderr, flush=True)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
