"""The RGB-D cell's comparison that decides ``correct``, at a small size on
the CPU: a sound run passes under the cell's limits; the control (the
reference in the program's place, in TF32, emulated here by rounding every
matrix product's and convolution's operands) and each fault a cell can
have, planted under the timed path, fail."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.controls import rgbd_keyframes as rgbd_control
from benchmark.frozen import depth_world
from benchmark.tests.helpers import REPO, cpu_as_card, emulated_tf32

CPU = torch.device("cpu")
CELL = "swarm5_rgbd640.rgbd_keyframes"
SMALL = {"drones": 2, "height": 96, "width": 128, "max_db_size": 64}


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def rgbd_tree(tmp):
    """``tmp`` holding the benchmark with a config ``small_rgbd`` (from
    swarm5_rgbd640, cut to SMALL, the focal length cut with the width) and
    the cell ``small_rgbd.rgbd_keyframes`` under the limits of the RGB-D
    cell, as ``helpers.small_tree`` builds its small cell."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/swarm5_rgbd640.json")
                     .read_text())
    cfg["name"] = "small_rgbd"
    cfg["swarm"]["drones"] = SMALL["drones"]
    fe = cfg["frontend"]
    for key in ("height", "width", "max_db_size"):
        fe[key] = SMALL[key]
    fe["fx"] = fe["fy"] = fe["fx"] * SMALL["width"] / 640
    fe["cx"], fe["cy"] = SMALL["width"] / 2, SMALL["height"] / 2
    (tmp / "benchmark/configs/small_rgbd.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "small_rgbd", "source": "a test size",
                            "file": "benchmark/configs/small_rgbd.json",
                            "reduced": [], "why": "CPU tests"})
    cell = "small_rgbd.rgbd_keyframes"
    spec["workloads"].append({"name": cell, "config": "small_rgbd",
                              "traffic": "rgbd_keyframes", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(cell)
    shutil.copy(tmp / f"benchmark/limits/{CELL}.json",
                tmp / f"benchmark/limits/{cell}.json")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return run.cell(tmp, cell)


@pytest.fixture
def rgbd_cell(tmp_path, monkeypatch):
    cpu_as_card(monkeypatch)
    return rgbd_tree(tmp_path)


def _correct(cell, seconds=0.3):
    out = run.measure(cell, 123456789012, seconds, False, CPU)
    return out["correct"], out["checks"]


def test_rgbd_sound_run_is_correct(rgbd_cell):
    ok, checks = _correct(rgbd_cell)
    assert ok, checks


def test_rgbd_depth_scaled_fails(rgbd_cell, monkeypatch):
    """Depths read 1% long (a z16 unit taken as 1.01 mm): the keypoints
    lifted, each to the same pixel, 1% deeper (a few near 10 m cross the
    far gate)."""
    from omniswarm_torch.swarm.loop_cam import LoopCam

    batch = LoopCam.on_depth_frames_batch

    def scaled(self, entries, depth_scale=1e-3):
        return batch(self, entries, depth_scale=1.01 * depth_scale)

    monkeypatch.setattr(LoopCam, "on_depth_frames_batch", scaled)
    ok, checks = _correct(rgbd_cell)
    assert not ok, checks
    assert checks["depth_gap_mm"]["value"] > checks["depth_gap_mm"]["limit"]
    # the same pixels: only the depth gap sees it
    assert checks["landmark_px"]["value"] <= checks["landmark_px"]["limit"]


def test_rgbd_holes_not_gated_fails(rgbd_cell, monkeypatch):
    """The near gate taken away: a keypoint over a hole (depth 0) keeps a
    landmark at the camera's centre."""
    import omniswarm_torch.swarm.loop_cam as lc

    monkeypatch.setattr(lc, "DEPTH_MIN_M", -1.0)
    ok, checks = _correct(rgbd_cell)
    assert not ok, checks
    assert checks["landmark_flips"]["value"] > 1, checks


def test_rgbd_one_drone_left_out_fails(rgbd_cell, monkeypatch):
    from omniswarm_torch.swarm.loop_cam import LoopCam

    batch = LoopCam.on_depth_frames_batch
    monkeypatch.setattr(LoopCam, "on_depth_frames_batch",
                        lambda self, entries, **kw: batch(self, entries[:-1],
                                                          **kw))
    ok, checks = _correct(rgbd_cell)
    assert not ok, checks


def test_rgbd_retrieval_altered_fails(rgbd_cell, monkeypatch):
    from omniswarm_torch.ops import placedb

    query = placedb.query_batch

    def altered(*a, **kw):
        idx, sims = query(*a, **kw)
        return (idx + 1) % a[0].desc.shape[0], sims

    monkeypatch.setattr(placedb, "query_batch", altered)
    ok, checks = _correct(rgbd_cell)
    assert not ok, checks


def test_rgbd_control_in_tf32_fails(rgbd_cell, monkeypatch):
    monkeypatch.setattr(rgbd_control, "tf32", emulated_tf32)
    row = rgbd_control.seed_row(rgbd_cell, 5, 3, True, CPU)
    limits = rgbd_cell.limits
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control_tf32"][k] > limits[k] for k in limits), row


def test_depth_maps_hold_the_sensor_model():
    """Depth is the camera-frame z of the wall the view shows: the pixel at
    the image centre of a camera facing a wall square on reads its
    distance; holes cover the share of blocks asked for."""
    from benchmark.frozen import image_world

    world = image_world.RoomWorld(half=6.0, seed=1)
    poses = torch.tensor([[1.0, 0.0, 1.0, 0.0], [0.0, 2.0, 1.0, np.pi / 2]],
                         dtype=torch.float64)
    z = depth_world.wall_depth(world, poses, 60.0, 60.0, 48, 64)
    assert torch.allclose(z[:, 24, 32], torch.tensor([5.0, 4.0],
                                                     dtype=torch.float64))
    # off-centre pixels of a square-on wall keep its distance as their z
    assert torch.allclose(z[0], torch.full_like(z[0], 5.0))
    gen = torch.Generator().manual_seed(3)
    sensor = {"noise_per_m2": 0.0, "hole_share": 0.25, "hole_block": 8}
    mm = depth_world.sensor_depth(z, sensor, gen)
    assert mm.dtype == torch.int32
    holes = (mm == 0).double().mean(dim=(1, 2))
    assert torch.equal(holes, torch.full((2,), 12 / 48, dtype=torch.float64))
    assert set(mm[mm > 0].tolist()) == {5000, 4000}
