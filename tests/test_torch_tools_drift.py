"""``omniswarm_torch.tools.drift_probe`` on the CPU at a small size: the
child refuses a tree whose ``omniswarm_torch`` resolves elsewhere, a
same-tree A/B gives equal iteration counts and bit-equal costs, and the
measured solve is the reference probe's (``tools/drift_probe.py``: the
JAX ``lm_solve_bt`` on the same window, cost within 1e-3)."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch.tools import drift_probe

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(drones=2, frames=12, reps=2)


def test_child_refuses_a_foreign_package(tmp_path, monkeypatch):
    """DIR holds no omniswarm_torch: the import resolves to this tree
    through PYTHONPATH, and the child exits without measuring."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    proc = drift_probe.run_child(tmp_path, device="cpu", timeout_s=120,
                                 **SMALL)
    assert proc.returncode == drift_probe.REFUSED, proc.stderr
    assert "outside" in proc.stderr and proc.stdout == ""


def test_child_refuses_a_tree_without_the_package(tmp_path, monkeypatch):
    monkeypatch.delenv("PYTHONPATH", raising=False)
    proc = drift_probe.run_child(tmp_path, device="cpu", timeout_s=120,
                                 **SMALL)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.fixture(scope="module")
def ab():
    """DIR given relative to the caller's working directory, as on the
    command line."""
    cwd = os.getcwd()
    os.chdir(ROOT.parent)
    try:
        return drift_probe.probe(ROOT.name, device="cpu",
                                 order=("other", "this"), **SMALL)
    finally:
        os.chdir(cwd)


def test_same_tree_ab_agrees(ab):
    rows, summary = ab["rows"], ab["summary"]
    assert [r["which"] for r in rows] == ["other", "this"]
    for r in rows:
        assert r["package"] == str(ROOT / "omniswarm_torch")
        assert r["card"] == "cpu"
        assert len(r["rep_iters"]) == SMALL["reps"]
        assert r["per_problem_iter_per_s"] > 0
        assert r["k1_launches"] == 0        # the plain level on the CPU
    assert summary["iters_equal"] and summary["costs_equal"]
    assert rows[0]["cost"] == rows[1]["cost"]
    assert rows[0]["rep_iters"] == rows[1]["rep_iters"]
    assert summary["this_over_other"] > 0
    json.dumps(ab)


def test_measured_solve_is_the_references(ab):
    import jax.numpy as jnp

    from omniswarm_tpu import sim
    from omniswarm_tpu.solver.dense import dense_graph_from_sim, lm_solve_bt

    data = sim.generate(sim.SimParams(num_drones=SMALL["drones"],
                                      num_frames=SMALL["frames"], seed=0))
    r = lm_solve_bt(dense_graph_from_sim(data),
                    jnp.asarray(data.vio, jnp.float32), max_iterations=100,
                    function_tolerance=0.0)
    got = ab["rows"][0]
    np.testing.assert_allclose(got["cost"], float(r.cost), rtol=1e-3)
    assert got["iters"] <= 100 and int(r.iterations) <= 100
