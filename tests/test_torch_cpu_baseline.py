"""The port's CPU baseline against ``tools/cpu_baseline.py``.

The numpy solvers (SuperLU and block-tridiagonal Thomas + Woodbury) are
copies of the reference tool's: on the same small graph (3 drones x 16
frames, seed 2), each built by its own package's simulator, they must end
at the same cost, bit for bit, after the same iterations. The torch rows
run the port's solvers on the CPU, and ``--out`` refuses the pre-port
``BASELINE_MEASURED.json``.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch import cpu_baseline as tcb
from omniswarm_torch import sim as tsim
from omniswarm_torch.solver.dense import dense_graph_from_sim as t_graph
from omniswarm_tpu import sim as jsim
from omniswarm_tpu.solver.dense import dense_graph_from_sim as j_graph

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PARAMS = dict(num_drones=3, num_frames=16, seed=2)
ITERS = 6


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_cpu_baseline", ROOT / "tools" / "cpu_baseline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problems():
    jd = jsim.generate(jsim.SimParams(**PARAMS))
    td = tsim.generate(tsim.SimParams(**PARAMS))
    np.testing.assert_array_equal(td.vio, jd.vio)
    return ((j_graph(jd), np.asarray(jd.vio, np.float64)),
            (t_graph(td), np.asarray(td.vio, np.float64)))


@pytest.mark.parametrize("solver", ["lm_solve_splu", "lm_solve_thomas"])
def test_numpy_solvers_equal_the_reference_tools(problems, solver):
    ref = _reference_tool()
    (jg, jx), (tg, tx) = problems
    want = getattr(ref, solver)(ref.NpGraph(jg), jx, ITERS)
    got = getattr(tcb, solver)(tcb.NpGraph(tg), tx, ITERS)
    assert got[2] == want[2] == ITERS
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("warm_up", [True, False])
def test_measure_rows_on_cpu(problems, warm_up):
    out = tcb.measure(iters=3, reps=1, problem=problems[1], warm_up=warm_up)
    for row in ("numpy_splu", "numpy_bt_thomas", "torch_cpu_bt"):
        assert out[row]["iters"] == 3 and np.isfinite(out[row]["final_cost"])
    assert out["torch_cpu_bt_batch8"]["iters"] == 3
    assert out["best_cpu_iter_per_s"] == max(
        out[r]["iter_per_s"] for r in ("numpy_splu", "numpy_bt_thomas",
                                       "torch_cpu_bt"))
    assert out["best_cpu_aggregate_iter_per_s"] >= out["best_cpu_iter_per_s"]
    json.dumps(out)


def test_out_refuses_the_pre_port_baseline(tmp_path):
    before = (ROOT / "BASELINE_MEASURED.json").read_bytes()
    with pytest.raises(SystemExit) as e:
        tcb.main(["--out", str(ROOT / "BASELINE_MEASURED.json")])
    assert e.value.code == 2
    assert (ROOT / "BASELINE_MEASURED.json").read_bytes() == before
