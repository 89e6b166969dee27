"""``omniswarm_torch.online_window`` against ``tools/online_window_bench.py``.

The reference tool's own ``build_estimator`` and ``ingest_tick`` drive the
JAX estimator; the port's copies drive the port's, on the CPU, at 96
frames with 60 loops, a first solve and 2 live solves. Each solve's window
(frame times) and PCM inlier sets must be equal and its cost within 1% (one
flipped accept), by ``online_window.held_to``. The iteration counts are
equal where a solve runs to the cap (the first solve, 50 in both); below
it rounding decides where a warm solve stops (the live solves: 4 against
3 and 3 against 24 iterations, their costs within 6e-6 relative).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch import online_window as tow

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FRAMES, LOOPS, SOLVES = 96, 60, 2


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_online_window_bench",
        ROOT / "tools" / "online_window_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_solves(frames, loops, solves):
    """The reference tool's session (its main loop, untimed) on the JAX
    estimator: the first solve's record and each live solve's."""
    ref = _reference_tool()
    est, rng, pose = ref.build_estimator(frames, loops)
    records = [tow.solve_record(est, est.solve())]
    t_now = 100.0 + frames
    for _ in range(solves):
        t_now += 1.0
        ref.ingest_tick(est, rng, pose, t_now)
        prep = est.prepare_solve()
        assert prep["dense_graph"] is not None
        records.append(tow.solve_record(
            est, est.finalize_solve(prep, est.execute_solve(prep))))
    return records


@pytest.fixture(scope="module")
def runs():
    port = tow.session("cpu", FRAMES, LOOPS, SOLVES, log=lambda m: None)
    return port, reference_solves(FRAMES, LOOPS, SOLVES)


def test_fields_of_online_1024(runs):
    port, _ = runs
    want = {"description", "frames", "loops_ingested",
            "host_build_ms_median", "device_solve_ms_median",
            "end_to_end_ms_median", "end_to_end_solves_per_s",
            "iterations_median", "device_ms_per_iter", "host_build_target_ms",
            "host_build_met", "one_hz_met"}
    assert want <= set(port)
    assert "first_solve_s" in port and "first_solve_compile_s" not in port
    assert port["frames"] == FRAMES and port["loops_ingested"] == LOOPS
    assert len(port["solves"]) == SOLVES + 1


@pytest.mark.parametrize("k", range(SOLVES + 1))
def test_solve_matches_the_reference(runs, k):
    got, want = runs[0]["solves"][k], runs[1][k]
    assert np.isfinite(got["cost"])
    assert tow.held_to(got, want) == [], (got, want)
    if k == 0:
        assert got["iterations"] == want["iterations"] == tow.MAX_ITERATIONS


def test_out_refuses_online_1024():
    before = (ROOT / "ONLINE_1024.json").read_bytes()
    with pytest.raises(SystemExit) as e:
        tow.main(["--device", "cpu", "--frames", "8", "--out",
                  str(ROOT / "ONLINE_1024.json")])
    assert e.value.code == 2
    assert (ROOT / "ONLINE_1024.json").read_bytes() == before


def test_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tow.main(["--frames", "8"])
