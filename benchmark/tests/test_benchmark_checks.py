"""The comparison that decides ``correct``, at small sizes on the CPU: a
sound run passes under the cells' limits; the control (the reference in
the program's place, in TF32, emulated here by rounding every matrix
product's and convolution's operands) and each fault a cell can have,
planted under the timed path, fail."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.controls import keyframes as kf_control
from benchmark.tests.helpers import cpu_as_card, emulated_tf32, small_tree

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def keyframes_cell(tmp_path, monkeypatch):
    cpu_as_card(monkeypatch)
    return run.cell(small_tree(tmp_path, "swarm10_w1024.keyframes"),
                    "small.keyframes")


def _correct(cell, seconds=0.3):
    out = run.measure(cell, 123456789012, seconds, False, CPU)
    return out["correct"], out["checks"]


def test_keyframes_sound_run_is_correct(keyframes_cell):
    ok, checks = _correct(keyframes_cell)
    assert ok, checks


def test_keyframes_answer_altered_where_produced_fails(keyframes_cell,
                                                       monkeypatch):
    from omniswarm_torch.swarm.loop_cam import LoopCam

    extract = LoopCam.extract_stereo_batch

    def altered(self, lefts, rights):
        xy, desc, gdesc, pts, ok = extract(self, lefts, rights)
        desc = desc.copy()
        desc[0, 0] = -desc[0, 0]
        return xy, desc, gdesc, pts, ok

    monkeypatch.setattr(LoopCam, "extract_stereo_batch", altered)
    ok, checks = _correct(keyframes_cell)
    assert not ok, checks


def test_keyframes_landmark_depth_scaled_fails(keyframes_cell, monkeypatch):
    """Landmarks a quarter deeper (a baseline taken as 0.25 m for 0.2 m),
    with the same keypoints triangulated."""
    from omniswarm_torch.swarm.loop_cam import LoopCam

    extract = LoopCam.extract_stereo_batch

    def scaled(self, lefts, rights):
        xy, desc, gdesc, pts, ok = extract(self, lefts, rights)
        return xy, desc, gdesc, pts * np.float32(1.25), ok

    monkeypatch.setattr(LoopCam, "extract_stereo_batch", scaled)
    ok, checks = _correct(keyframes_cell)
    assert not ok, checks
    assert checks["landmark_flips"]["value"] == 0, checks


def test_keyframes_half_the_batch_left_out_fails(keyframes_cell,
                                                 monkeypatch):
    """Each keyframe's global descriptor is the mean over its 4 views:
    taken over the first two only."""
    import omniswarm_torch.swarm.loop_cam as lc

    mean = np.mean

    def half_mean(values, axis=None, **kw):
        if axis == 0 and isinstance(values, list) and len(values) == 4:
            values = values[:2]
        return mean(values, axis=axis, **kw)

    monkeypatch.setattr(lc.np, "mean", half_mean)
    ok, checks = _correct(keyframes_cell)
    assert not ok, checks


def test_keyframes_database_left_unchanged_fails(keyframes_cell,
                                                 monkeypatch):
    """A step that leaves its state, the place database, as it was."""
    from omniswarm_torch.ops import placedb

    monkeypatch.setattr(placedb, "add", lambda db, *a, **kw: db)
    ok, checks = _correct(keyframes_cell, seconds=1.0)
    assert not ok, checks


def test_keyframes_retrieval_altered_fails(keyframes_cell, monkeypatch):
    from omniswarm_torch.ops import placedb

    query = placedb.query_batch

    def altered(*a, **kw):
        idx, sims = query(*a, **kw)
        return (idx + 1) % a[0].desc.shape[0], sims

    monkeypatch.setattr(placedb, "query_batch", altered)
    ok, checks = _correct(keyframes_cell)
    assert not ok, checks


def test_keyframes_control_in_tf32_fails(keyframes_cell, monkeypatch):
    monkeypatch.setattr(kf_control, "tf32", emulated_tf32)
    row = kf_control.seed_row(keyframes_cell, 5, 3, True, CPU)
    limits = keyframes_cell.limits
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control_tf32"][k] > limits[k] for k in limits), row


@pytest.fixture
def card_cell(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return run.cell(small_tree(tmp_path, "swarm10_w1024.keyframes"),
                    "small.keyframes")


@pytest.mark.cuda
def test_keyframes_control_in_card_tf32_fails(card_cell):
    row = kf_control.seed_row(card_cell, 7, 4, True, torch.device("cuda"))
    limits = card_cell.limits
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control_tf32"][k] > limits[k] for k in limits), row
