"""``omniswarm_torch.tools.comm_model`` at world 8 on gloo CPU ranks, F =
256: the port's LM iteration exchanges what ``COMM_MODEL.json`` recorded
from the JAX program's HLO plus the one named ``[cost | bad]`` psum, call
for call and byte for byte; the fleet layout exchanges no data."""
import json
from pathlib import Path

import pytest
import torch

from omniswarm_torch.tools import comm_model

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
F = 256


@pytest.fixture(scope="module")
def recorded():
    with open(ROOT / "COMM_MODEL.json") as f:
        rows = json.load(f)["frame_sharded"]
    return {r["F"]: r for r in rows}


@pytest.fixture(scope="module")
def comm():
    return comm_model.traffic(frames=(F,), ndev=8, timeout_s=300)


def test_problem_is_comm_model_json(comm, recorded):
    row, want = comm["frame_sharded"][0], recorded[F]
    for key in ("F", "D", "loops", "woodbury_cols"):
        assert row[key] == want[key], key


def test_lm_iteration_differs_by_the_named_psum(comm, recorded):
    row, want = comm["frame_sharded"][0], recorded[F]
    lm = row["lm_iteration"]
    assert lm["by_op"] == comm_model.expected_by_op(want["by_op"])
    for op in ("all-gather", "collective-permute"):
        assert lm["by_op"][op] == want["by_op"][op], op
    C = row["woodbury_cols"]
    assert lm["by_op"]["all-reduce"] == {"count": 2,
                                         "bytes": 4 * (C * C + C) + 4 * 2}
    assert want["by_op"]["all-reduce"] == {"count": 1,
                                           "bytes": 4 * (C * C + C) + 4}
    assert lm["collectives_per_iter"] == want["collectives_per_iter"] + 1
    assert lm["collective_bytes_per_iter"] == \
        want["collective_bytes_per_iter"] + 4
    assert lm["axis_counters"]["psum"] == {"calls": 2,
                                           "bytes": 4 * (C * C + C + 2)}


def test_fleet_exchanges_no_data(comm):
    assert comm["fleet_layout_zero_data_collectives"]
    assert comm["fleet_layout_data_collectives"] == 0
    assert list(comm["fleet_layout_counters"]) == ["all_gather/output"]
    assert comm["fleet_layout_counters"]["all_gather/output"]["calls"] == 1


def test_prediction_is_the_formula_with_assumed_inputs(comm):
    t1 = {F: (2.0, 4.0)}
    out = comm_model.predict(comm, t1, "cpu", bw=1e9, latency=(1e-6, 1e-5))
    row = out["frame_sharded"][0]
    lm = row["lm_iteration"]
    want = [2.0 / 8 + lm["collective_bytes_per_iter"] / 1e9 * 1e3
            + lm["collectives_per_iter"] * lat * 1e3 for lat in (1e-6, 1e-5)]
    assert row["tN_ms_per_iter_pred"] == pytest.approx(want, rel=1e-12)
    assert row["speedup_pred"] == pytest.approx([2.0 / want[1],
                                                 2.0 / want[0]])
    assert out["assumed"]["bw_bytes_per_s"] == 1e9
    assert out["measured"]["card"] == "cpu"
    assert "predicted" in out["prediction_only"]
    diff = out["difference_from_comm_model_json"]
    assert diff["by_op"] == {"all-reduce": {"count": 1, "bytes": 4}}
    assert "[cost | bad]" in diff["why"]
    text = json.dumps(out)
    for tpu in ("45000000000.0", "0.48", "2.104"):   # the v5e inputs
        assert tpu not in text


def test_world1_timing_on_the_cpu():
    got = comm_model.world1_ms((64,), "cpu", iters=2, reps=1)
    ms, k1 = got[64]
    assert ms > 0 and k1 == 0


def test_out_refuses_the_repositorys_artifacts(capsys):
    for out in ("COMM_MODEL.json", "NETVLAD_EVAL.json"):
        with pytest.raises(SystemExit) as e:
            comm_model.main(["--device", "cpu", "--out", str(ROOT / out)])
        assert e.value.code == 2
    assert "reference artifact" in capsys.readouterr().err
