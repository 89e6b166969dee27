"""BENCHMARK.json against the benchmark's contract, discovery by name, and
the imports of every module under ``benchmark/``."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from benchmark import run
from benchmark.tests.helpers import REPO, cpu_as_card, small_tree

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "-m", "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for part, allowed in keys.items():
        names = [x["name"] for x in SPEC[part]]
        assert len(names) == len(set(names))
        for x in SPEC[part]:
            assert set(x) == allowed, x
            assert NAME.match(x["name"]), x["name"]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_its_layers_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = [w["name"] for w in SPEC["workloads"]]
    reports = {c: {n for n, m in e2e.items()
                   if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert len(reports[c]) >= 2, c
        assert any(c in m.get("workloads", cells)
                   for m in SPEC["per_layer"]), c
    for m in SPEC["per_layer"]:
        for c in m.get("workloads", cells):
            assert m["moves"] in reports[c], (m["name"], c)


def test_files_are_found_by_name():
    bench = REPO / "benchmark"
    for conf in SPEC["configs"]:
        body = json.loads((REPO / conf["file"]).read_text())
        assert body["name"] == conf["name"]
        assert body["reduced"] == conf["reduced"]
        assert body["source"] == conf["source"]
        assert body["assumed"]
    for w in SPEC["workloads"]:
        c = run.cell(REPO, w["name"])
        assert c.driver.exists() and c.limits
        assert all(p.exists() for p in c.readers.values())
        assert w["chips"] == 1
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists(), m["name"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in (REPO / "benchmark").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in run.FORBIDDEN, (path, name)
            if "reference" in path.parts:
                assert top != "omniswarm_torch", (path, name)


def test_a_run_without_a_card_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_are_files_only(tmp_path,
                                                     monkeypatch):
    """A cell on a new configuration under a new traffic mix, with a new
    metric, runs from added files and entries alone."""
    cpu_as_card(monkeypatch)
    root = small_tree(tmp_path, "swarm5_w1024.keyframes")
    before = _digests(REPO)
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic/keyframes.json").read_text())
    traffic["pool_views"] = 32
    (bench / "traffic/small_pool.json").write_text(json.dumps(traffic))
    (bench / "metrics/steps_per_s.py").write_text(
        "def read(rec):\n"
        "    n = rec.counts.get('steps')\n"
        "    return n / rec.window_s if n else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "small.small_pool", "config": "small",
                              "traffic": "small_pool", "chips": 1,
                              "why": "a new mix"})
    spec["end_to_end"].append({"name": "steps_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["small.small_pool"]})
    (bench / "limits/small.small_pool.json").write_text(
        (bench / "limits/swarm5_w1024.keyframes.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert {k: v for k, v in _digests(root).items() if k in before} \
        == before
    torch.set_num_threads(2)
    out = run.measure(run.cell(root, "small.small_pool"), 11, 0.2, False,
                      torch.device("cpu"))
    assert out["metrics"]["steps_per_s"]["value"] > 0
    assert set(out["metrics"]) == {"steps_per_s", "setup_s"}
    assert out["correct"], out["checks"]


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, torch, pytest; from pathlib import Path; "
        "sys.path.insert(0, sys.argv[1]); from benchmark import run; "
        "from benchmark.tests.helpers import cpu_as_card; "
        "cpu_as_card(pytest.MonkeyPatch()); torch.set_num_threads(2); "
        "run.measure(run.cell(Path(sys.argv[2]), 'small.keyframes'), 5, "
        "0.1, False, torch.device('cpu')); print(run.forbidden_modules())")
    root = small_tree(tmp_path, "swarm5_w1024.keyframes")
    out = subprocess.run([sys.executable, "-c", code, str(REPO), str(root)],
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
