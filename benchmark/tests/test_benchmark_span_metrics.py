"""The readers of the keyframe step's host-phase ranges
(``stage_idle_ms_per_step``, ``merge_idle_ms_per_step``,
``placedb_idle_ms_per_step``, ``transfer_ms_per_step``) on hand-made
traces, and the frozen labelling of idle gaps that the first three read."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.frozen.trace import Trace, _idle_by_host
from benchmark.tests.helpers import REPO

IDLE = ("stage_idle_ms_per_step", "merge_idle_ms_per_step",
        "placedb_idle_ms_per_step")
UPLOAD = ("frontend/upload", 0.0, 10.0)


def reader(name):
    return run.load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                           "test_metric_" + name)


def rec(idle, steps=4, ranges=(UPLOAD,), kernels=()):
    trace = Trace(list(kernels), list(ranges), 0.0, 1.0,
                  [[k, v] for k, v in idle])
    return SimpleNamespace(trace=trace, counts={"steps": steps})


def fillers(n):
    """``n`` labels of other host ops, each 1 ms, as a list sorted by
    size would hold them below larger ones."""
    return [(f"aten::op{i}", 0.001) for i in range(n)]


@pytest.mark.parametrize("name, idle, want_ms", [
    ("stage_idle_ms_per_step", [("frontend/stage", 0.02)], 20.0),
    ("merge_idle_ms_per_step", [("frontend/merge", 0.012)], 12.0),
    ("placedb_idle_ms_per_step",
     [("placedb/add", 0.006), ("placedb/query", 0.002)], 8.0),
])
def test_labels_summed_and_divided_by_steps(name, idle, want_ms):
    other = [("host between ops", 0.05), ("frontend/retrieval", 0.03)]
    for steps in (1, 4):
        got = reader(name).read(rec(other + idle, steps=steps))
        assert got == pytest.approx(want_ms / steps)


@pytest.mark.parametrize("name", IDLE)
def test_missing_label_in_a_short_list_reads_zero(name):
    assert reader(name).read(rec(fillers(9))) == 0.0


@pytest.mark.parametrize("name, missing", [
    ("stage_idle_ms_per_step", 1), ("merge_idle_ms_per_step", 1),
    ("placedb_idle_ms_per_step", 2)])
def test_missing_label_in_a_full_list_reads_the_tenth(name, missing):
    idle = [("host between ops", 0.05)] + fillers(8) + [("aten::tenth",
                                                         0.0004)]
    got = reader(name).read(rec(idle, steps=2))
    assert got == pytest.approx(missing * 0.4 / 2)


def test_placedb_one_label_cut_from_a_full_list():
    idle = ([("host between ops", 0.05), ("placedb/add", 0.006)]
            + fillers(7) + [("aten::tenth", 0.0004)])
    got = reader("placedb_idle_ms_per_step").read(rec(idle, steps=2))
    assert got == pytest.approx((6.0 + 0.4) / 2)


@pytest.mark.parametrize("name", IDLE + ("transfer_ms_per_step",))
def test_nothing_without_a_trace_or_the_ranges(name):
    m = reader(name)
    assert m.read(SimpleNamespace(trace=None, counts={"steps": 3})) is None
    assert m.read(rec([("frontend/stage", 0.02)], steps=0)) is None
    # a program without the ranges: its trace holds no frontend/upload
    parent = rec([("host between ops", 0.1), ("frontend/stage", 0.02)],
                 ranges=[("frontend/superpoint_net", 0.0, 5.0)],
                 kernels=[("conv", 1.0, 2.0)])
    assert m.read(parent) is None


def test_transfer_reads_the_copies_innermost_in_the_two_ranges():
    ranges = [("frontend/upload", 0.0, 300.0),
              ("frontend/superpoint_net", 400.0, 900.0),
              ("frontend/download", 1000.0, 1200.0),
              ("frontend/retrieval", 1300.0, 1600.0)]
    kernels = [("Memcpy HtoD (Pageable -> Device)", 10.0, 290.0),
               ("conv", 400.0, 880.0),
               ("Memcpy DtoH (Device -> Pageable)", 1000.0, 1050.0),
               ("Memcpy DtoH (Device -> Pageable)", 1100.0, 1170.0),
               ("Memcpy HtoD (Pageable -> Device)", 1300.0, 1310.0),
               ("retrieval_kernel", 1320.0, 1350.0)]
    for steps in (1, 2):
        got = reader("transfer_ms_per_step").read(
            rec([], steps=steps, ranges=ranges, kernels=kernels))
        assert got == pytest.approx((280.0 + 50.0 + 70.0) / 1e3 / steps)


def test_frozen_labels_a_gap_inside_a_merge_span_with_no_children():
    kernels = [("conv", 0.0, 100.0), ("Memcpy DtoH", 100.0, 120.0),
               ("Memcpy HtoD", 900.0, 950.0)]
    host = [("frontend/download", 90.0, 125.0),
            ("aten::copy_", 95.0, 124.0),
            ("frontend/merge", 130.0, 700.0),
            ("frontend/retrieval", 710.0, 1000.0),
            ("aten::to", 880.0, 960.0)]
    assert _idle_by_host(kernels, host) == [["frontend/merge", 780.0 / 1e6]]
