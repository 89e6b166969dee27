"""``omniswarm_torch.bench``: every row at a small size on the CPU.

The rows run at F = 16 (3 LM iterations, 1 repetition) and the front-end
at B = 2 on 64 x 96 views; the line must carry every key of the
reference's (``BENCH_r05.json``'s ``parsed``) with the card's peaks
supplied. The inits are held to the reference bench's numpy draws bit for
bit, ``pert`` to its range, and the operation counter to a GEMM's known
FLOPs and bytes.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch import bench, bench_frontend
from omniswarm_torch import sim as tsim
from omniswarm_torch.benchutil import (CARD_PEAKS, batch_inits, count_ops,
                                       pert)
from omniswarm_tpu import sim as jsim

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = bench.Sizes(frames=16, big_frames=16, iters=3, big_iters=3,
                    d10_iters=3, fleet_iters=3, reps=1, big_reps=1,
                    frontend_hw=(64, 96), frontend_batches=(2, 2, 2),
                    fused_batch=2, frontend_calls=1, fused_calls=1,
                    frontend_runs=1)
EXTRA = {"card", "kernel_launches", "row_seconds"}


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    """The bench at SMALL on the CPU, with the H100's peaks supplied and a
    CPU baseline file."""
    base = tmp_path_factory.mktemp("bench") / "baseline.json"
    base.write_text(json.dumps({"best_cpu_iter_per_s": 10.0,
                                "best_cpu_aggregate_iter_per_s": 20.0,
                                "host": "x86_64", "nproc": 8}))
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "card_peaks",
               lambda dev: CARD_PEAKS["NVIDIA H100 80GB HBM3"])
    try:
        out = bench.run("cpu", str(base), sizes=SMALL)
    finally:
        mp.undo()
    json.dumps(out)
    return out


def test_key_set_is_the_references(line):
    want = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert len(want) == 51
    assert set(line) - EXTRA == set(want)
    assert not any(k.endswith("_error") for k in line)


def test_rows_measured(line):
    for k, v in line.items():
        if k not in ("metric", "unit", "card", "kernel_launches",
                     "row_seconds", "frontend_dtype", "cpu_baseline_host",
                     "chip_kind"):
            assert v is not None and np.isfinite(v) and v >= 0, k
    assert line["card"] == "cpu"
    # ratios of unrounded rates, checked against the rounded ones
    assert line["vs_baseline"] == pytest.approx(line["value"] / 10.0,
                                                abs=1e-3)
    assert line["vs_baseline_measured_aggregate"] == pytest.approx(
        line["aggregate_iter_per_s_batch8"] / 20.0, abs=1e-3)
    assert line["cpu_baseline_host"] == "x86_64x8"
    assert line["kf1024_fused_cost_delta"] <= bench.FUSED_COST_BAR
    assert line["solver_flops_per_iter"] > 0
    assert line["chip_critical_intensity"] == round(989.4e12 / 3.35e12, 1)
    # the plain versions run on the CPU: no kernel launch is counted
    assert set(line["kernel_launches"]) == {"headline", *bench.ROWS}
    assert all(v == {"k1": 0, "k2": 0}
               for v in line["kernel_launches"].values())


def test_row_seconds(line):
    assert set(line["row_seconds"]) == {"headline", *bench.ROWS}
    assert all(v >= 0 for v in line["row_seconds"].values())


def test_rows_without_warm_up_time_their_first_solve():
    """``warm_up=False`` (chip_smoke.py's setting): each solver row's
    checked solve is its timed one."""
    out = bench.run("cpu", "absent.json", rows=("kf1024", "fleet"),
                    sizes=SMALL._replace(warm_up=False))
    for k in ("value", "aggregate_iter_per_s_batch8", "kf1024_iter_per_s",
              "fleet_aggregate_iter_per_s", "fleet_windows_per_s"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["kf1024_fused_cost_delta"] <= bench.FUSED_COST_BAR
    assert set(out["row_seconds"]) == {"headline", "kf1024", "fleet"}


def test_baseline_absent_gives_nulls(tmp_path):
    ctx = {"per_problem": 5.0, "aggregate": 7.0}
    got = bench.baseline(tmp_path / "none.json", ctx)
    assert got["vs_baseline"] is None and got["cpu_baseline_host"] == "?x?"
    assert got["vs_baseline_measured_aggregate"] is None


def test_batch8_inits_are_bench_pys_draw():
    """bench.py:148-156, as the reference writes it, on the reference
    simulator's VIO."""
    data = jsim.generate(jsim.SimParams(num_drones=5, num_frames=100,
                                        seed=0))
    init = np.asarray(data.vio, np.float32)
    rng = np.random.default_rng(0)
    want = np.tile(init[None], (8, 1, 1, 1))
    for b in range(1, 8):
        want[b, :, 1:, :3] += rng.normal(
            0, 0.4, size=(100, 4, 3)).astype(np.float32)
    port = tsim.generate(tsim.SimParams(num_drones=5, num_frames=100,
                                        seed=0))
    np.testing.assert_array_equal(
        batch_inits(np.asarray(port.vio, np.float32)), want)


def test_fleet_inits_and_capacity_are_bench_pys():
    """bench.py:364-374: seeds 100-107, the loop capacity of the largest
    lane (at least 8)."""
    ref = [jsim.generate(jsim.SimParams(num_drones=5, num_frames=100,
                                        seed=100 + k)) for k in range(8)]
    port = [tsim.generate(tsim.SimParams(num_drones=5, num_frames=100,
                                         seed=100 + k)) for k in range(8)]
    np.testing.assert_array_equal(
        np.stack([np.asarray(d.vio, np.float32) for d in port]),
        np.stack([np.asarray(d.vio, np.float32) for d in ref]))
    assert (max(8, max(len(d.loops) for d in port))
            == max(8, max(len(d.loops) for d in ref)))


@pytest.mark.parametrize("k", [0, 3])
def test_pert_nudges_one_element(k):
    x = np.random.default_rng(1).normal(size=(4, 3))
    eps = 1e-6
    got = pert(x, k, eps)
    d = got - x
    assert (k + 1) * eps <= d.reshape(-1)[0] < (k + 2) * eps
    assert not d.reshape(-1)[1:].any()
    assert not (pert(x, k, eps) == got).all()      # a fresh draw each call


def test_op_counter_on_a_gemm():
    m, k, n = 48, 32, 24
    a, b = torch.randn(m, k), torch.randn(k, n)
    flops, nbytes, out = count_ops(lambda: a @ b)
    assert flops == 2 * m * n * k
    assert nbytes == 4 * (m * k + k * n + m * n)
    torch.testing.assert_close(out, a @ b)


def test_op_counter_skips_views():
    x = torch.randn(8, 16)
    assert count_ops(lambda: x.reshape(16, 8).t())[:2] == (0, 0)


def test_unknown_card_leaves_efficiency_out(capsys):
    from omniswarm_torch.benchutil import card_peaks

    assert card_peaks("cpu") is None
    assert "efficiency fields are left out" in capsys.readouterr().out


def test_bench_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


def test_bench_frontend_line():
    out = bench_frontend.run("cpu", hw=(64, 96), batch=2, calls=1)
    assert set(out) == {"metric", "value", "unit", "keyframes_per_s_4dir",
                        "card"}
    assert out["value"] > 0 and out["card"] == "cpu"
