"""For the CPU tests: a benchmark tree at small sizes in a temporary
directory (a copy of ``benchmark/`` and ``BENCHMARK.json`` plus one small
configuration and its cell, found by name as the full ones are), the
card's calls stood in for, and TF32 emulated."""
from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

REPO = Path(__file__).resolve().parents[2]
SMALL = {"drones": 2, "height": 96, "width": 160, "max_db_size": 64}


def small_tree(tmp: Path, limits_from: str) -> Path:
    """``tmp`` holding the benchmark with a config ``small`` (from
    swarm5_w1024, cut to SMALL) and the cell ``small.keyframes`` under the
    limits of cell ``limits_from``."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/swarm5_w1024.json")
                     .read_text())
    cfg["name"] = "small"
    cfg["swarm"]["drones"] = SMALL["drones"]
    for key in ("height", "width", "max_db_size"):
        cfg["frontend"][key] = SMALL[key]
    (tmp / "benchmark/configs/small.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "small", "source": "a test size",
                            "file": "benchmark/configs/small.json",
                            "reduced": [], "why": "CPU tests"})
    cell = "small.keyframes"
    spec["workloads"].append({"name": cell, "config": "small",
                              "traffic": "keyframes", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if limits_from in m.get("workloads", ()):
            m["workloads"].append(cell)
    shutil.copy(tmp / f"benchmark/limits/{limits_from}.json",
                tmp / f"benchmark/limits/{cell}.json")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def cpu_as_card(monkeypatch) -> None:
    """The harness's calls to the card, stood in for so that a run goes
    through on the CPU: synchronise does nothing, the peak reads 0, the
    card is named ``cpu``."""
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(run, "card", lambda index=0: {
        "kind": "cpu", "power_limit": "none"})


def tf32_round(x):
    """x rounded to TF32's 11 significant bits, to nearest (Veltkamp's
    split: arithmetic only)."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    t = x * 8193.0                  # 2^(24 - 11) + 1
    return t - (t - x)


class EmulatedTF32(TorchFunctionMode):
    """Matrix products and convolutions with their float32 operands (the
    input and the weight of a convolution, not its bias) rounded to
    TF32, as the card's TF32 rounds them."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.matmul, torch.Tensor.matmul,
                    torch.Tensor.__matmul__, torch.bmm, torch.mm, torch.mv):
            args = tuple(tf32_round(a) for a in args)
        elif func in (torch.conv2d, torch.nn.functional.conv2d):
            args = tuple(tf32_round(a) for a in args[:2]) + tuple(args[2:])
        elif func is torch.einsum:
            args = (args[0],) + tuple(tf32_round(a) for a in args[1:])
        return func(*args, **kwargs)


@contextlib.contextmanager
def emulated_tf32():
    with EmulatedTF32():
        yield
