"""The port stands alone: no JAX at run time, no silent CPU fallback, and a
faithful conversion of the reference's graph container."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.convert import dense_graph_to_torch, warm_state_to_torch
from omniswarm_torch.solver.dense import DenseGraph
from omniswarm_tpu import sim
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "omniswarm_tpu")


def _port_files():
    files = sorted((ROOT / "omniswarm_torch").rglob("*.py"))
    # with the scripts and the cuda tests that run on the card, where JAX is
    # not installed
    return files + [ROOT / "chip_smoke.py", ROOT / "tools/torch_repro_solve.py",
                    ROOT / "tools/demo_draw_spread.py"] + [
        ROOT / f"tests/test_torch_{name}.py"
        for name in ("kernels_card", "conv_epilogue", "conv3x3", "rgbd",
                     "stereo_merge")] + [
        ROOT / "tests/kernel_inputs.py"]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("chip_smoke.py", "omniswarm_torch/entry.py",
                 "omniswarm_torch/solver/fused_level.py",
                 "omniswarm_torch/kernels.py",
                 "omniswarm_torch/frontend_entry.py",
                 "omniswarm_torch/solver/gauss_newton.py",
                 "omniswarm_torch/sim/pipeline.py",
                 "omniswarm_torch/ops/frontend_kernels.py",
                 "omniswarm_torch/config.py",
                 "omniswarm_torch/core/trajectory.py",
                 "omniswarm_torch/runtime/native.py",
                 "omniswarm_torch/robust/pcm.py",
                 "omniswarm_torch/robust/da_init.py",
                 "omniswarm_torch/utils/telemetry.py",
                 "omniswarm_torch/swarm/fastbuild.py",
                 "omniswarm_torch/swarm/estimator.py",
                 "omniswarm_torch/io/checkpoint.py",
                 "omniswarm_torch/io/recorder.py",
                 "omniswarm_torch/estimator_entry.py",
                 "omniswarm_torch/demo_entry.py",
                 "omniswarm_torch/swarm/comm.py",
                 "omniswarm_torch/swarm/proxy.py",
                 "omniswarm_torch/swarm/loop_detector.py",
                 "omniswarm_torch/swarm/node.py",
                 "omniswarm_torch/sim/visual_world.py",
                 "omniswarm_torch/ops/homography.py",
                 "omniswarm_torch/ops/ransac.py",
                 "omniswarm_torch/ops/camera.py",
                 "omniswarm_torch/parallel/collectives.py",
                 "omniswarm_torch/parallel/launch.py",
                 "omniswarm_torch/parallel/bt_spike.py",
                 "omniswarm_torch/parallel/sharded_solver.py",
                 "omniswarm_torch/parallel/sharded_window.py",
                 "omniswarm_torch/parallel/swarm_batch.py",
                 "omniswarm_torch/parallel_entry.py",
                 "omniswarm_torch/runtime/udp_transport.py",
                 "omniswarm_torch/runtime/run_node.py",
                 "omniswarm_torch/runtime/drone_process.py",
                 "omniswarm_torch/node_entry.py",
                 "omniswarm_torch/eval/report.py",
                 "omniswarm_torch/eval/pcm_debug.py",
                 "omniswarm_torch/eval/match_viz.py",
                 "omniswarm_torch/eval/calibration.py",
                 "omniswarm_torch/io/flightlog.py",
                 "omniswarm_torch/utils/cgraph.py",
                 "omniswarm_torch/utils/diagnostics.py",
                 "omniswarm_torch/models/train_superpoint.py",
                 "omniswarm_torch/models/train_netvlad.py",
                 "omniswarm_torch/train_entry.py",
                 "omniswarm_torch/bench.py",
                 "omniswarm_torch/bench_kernels.py",
                 "tests/test_torch_kernels_card.py",
                 "omniswarm_torch/bench_frontend.py",
                 "omniswarm_torch/online_window.py",
                 "omniswarm_torch/cpu_baseline.py",
                 *(f"omniswarm_torch/tools/{name}.py"
                   for name in ("__init__", *TOOLS))):
        assert want in names
    for cu in ("fused_level", "grid_nms", "retrieval_top1"):
        assert (ROOT / f"omniswarm_torch/csrc/{cu}.cu").exists()
    assert (ROOT / "omniswarm_torch/csrc/maxclique.cpp").exists()
    assert (ROOT / "omniswarm_torch/csrc/udp_multicast.cpp").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_entry_points_raise_without_cuda(monkeypatch):
    from omniswarm_torch.entry import entry
    from omniswarm_torch.solver.dense import lm_solve_bt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    data = sim.generate(sim.SimParams(num_drones=2, num_frames=4, seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_solve_bt(jdense.dense_graph_from_sim(data), data.vio)


def test_estimator_entry_points_raise_without_cuda(monkeypatch):
    from omniswarm_torch.estimator_entry import estimator_entry
    from omniswarm_torch.io.checkpoint import load_estimator
    from omniswarm_torch.robust.pcm import (loopset_from_measurements,
                                            pcm_filter, pcm_launch_all)
    from omniswarm_torch.swarm import SwarmEstimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = sim.generate(sim.SimParams(num_drones=2, num_frames=12, seed=0))
    loops = loopset_from_measurements(data.loops)
    assert len(data.loops)
    for call in (SwarmEstimator, estimator_entry,
                 lambda: load_estimator("unused.npz"),
                 lambda: pcm_filter(loops, data.vio),
                 lambda: pcm_launch_all(loops, data.vio)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    SwarmEstimator(device="cpu")


def test_solver_entry_points_raise_without_cuda(monkeypatch):
    from omniswarm_torch.sim.pipeline import build_graph_from_sim
    from omniswarm_torch.solver import dense as tdense
    from omniswarm_torch.solver import gauss_newton as tgn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = sim.generate(sim.SimParams(num_drones=2, num_frames=4, seed=0))
    dg = jdense.dense_graph_from_sim(data)
    fg, init = build_graph_from_sim(data)
    batch = np.stack([init, init])
    for call in (lambda: tdense.lm_solve_dense(dg, init),
                 lambda: tdense.lm_solve_dense_batched(dg, batch),
                 lambda: tdense.lm_solve_bt_batched(dg, batch),
                 lambda: tdense.pose_covariances(dg, init, [[0, 1]]),
                 lambda: tgn.lm_solve(fg, init),
                 lambda: tgn.lm_solve_multi_init(fg, batch)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_frontend_entry_raises_without_cuda(monkeypatch):
    from omniswarm_torch.frontend_entry import frontend_entry
    from omniswarm_torch.models.netvlad import pretrained_global_extractor
    from omniswarm_torch.models.superpoint import pretrained_extractor
    from omniswarm_torch.ops.placedb import make_placedb
    from omniswarm_torch.swarm.loop_cam import LoopCam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (frontend_entry, LoopCam, pretrained_extractor,
                  pretrained_global_extractor, lambda: make_placedb(8, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_demo_entry_points_raise_without_cuda(monkeypatch):
    from omniswarm_torch.demo_entry import (feature_demo_entry,
                                            image_demo_entry)
    from omniswarm_torch.swarm.comm import LossyBus
    from omniswarm_torch.swarm.loop_detector import LoopDetector
    from omniswarm_torch.swarm.node import DroneNode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (feature_demo_entry, image_demo_entry,
                  lambda: DroneNode(0, LossyBus(), global_dim=8),
                  lambda: DroneNode(0, LossyBus(), global_dim=8,
                                    device="cuda"),
                  lambda: LoopDetector(0, global_dim=8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    node = DroneNode(0, LossyBus(), global_dim=8, device="cpu")
    assert node.detector.device.type == "cpu"
    assert node.estimator.device.type == "cpu"


def test_parallel_entry_points_raise_without_cuda(monkeypatch):
    from omniswarm_torch.parallel.launch import call_each, run_ranks
    from omniswarm_torch.parallel_entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dryrun_multichip(2),
                 lambda: run_ranks(call_each, 2, backend="gloo",
                                   args=([],))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # nccl takes CUDA tensors only: no CPU run through it
    with pytest.raises(ValueError, match="nccl"):
        run_ranks(call_each, 1, backend="nccl", device="cpu", args=([],))


def test_node_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from omniswarm_torch import node_entry
    from omniswarm_torch.node_entry import paced_sessions
    from omniswarm_torch.runtime import drone_process, run_node

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ROOT / "configs" / "swarm5.yaml"
    for call in (lambda: run_node.main(["--config", str(cfg), "--no-udp"]),
                 lambda: drone_process.main([
                     "--scenario", str(tmp_path / "none.npz"),
                     "--drone-id", "0", "--out", str(tmp_path / "o.npz")]),
                 paced_sessions,
                 lambda: node_entry.main(["--swarm", "2", "3", "--out-dir",
                                          str(tmp_path / "swarm")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_train_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from omniswarm_torch import train_entry
    from omniswarm_torch.models import train_netvlad as tnv
    from omniswarm_torch.models import train_superpoint as tsp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "ckpt.npz")
    for call in (tsp.train_detector, tsp.train_descriptors,
                 tnv.train_netvlad,
                 lambda: tsp.detection_metrics({}),
                 lambda: tsp.matching_metrics({}),
                 lambda: tsp.sample_raw_descriptors({}),
                 lambda: tnv.retrieval_metrics({}),
                 lambda: train_entry.superpoint_main(["--out", out]),
                 lambda: train_entry.netvlad_main(["--out", out])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_measurement_entry_points_raise_without_cuda(monkeypatch):
    from omniswarm_torch import bench, bench_frontend, online_window
    from omniswarm_torch.models.netvlad import pretrained_global_extractor
    from omniswarm_torch.models.superpoint import pretrained_extractor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.main([]), lambda: bench_frontend.main([]),
                 lambda: online_window.main(["--frames", "8"]),
                 lambda: pretrained_extractor(dtype=torch.bfloat16),
                 lambda: pretrained_global_extractor(dtype=torch.bfloat16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# omniswarm_torch/tools/: each module that runs device work, with the
# least arguments it takes
TOOLS = {"window_scale_sweep": [], "bench_dense_loops": [],
         "profile_fscale": [], "profile_f100": [], "profile_solver": [],
         "profile_fleet": [], "replay_eval": ["--logs", "a.csv:0"],
         "eval_superpoint_textured": ["--ckpt", "a=b.npz"],
         "drift_probe": ["."], "comm_model": []}
# the host-only tools (the bus tools, the PCA fit, the weight converter),
# on UDP port 17933
HOST_TOOLS = {"bus_spy": ["--duration", "0", "--port", "17933"],
              "network_tester": ["--drone-id", "0", "--duration", "0",
                                 "--port", "17933"],
              "fit_pca": ["--dim", "4"],
              "convert_superpoint": ["--pth", "sp.pth"]}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tools_raise_without_cuda(monkeypatch, name):
    """Every tool refuses to start without CUDA unless given --device cpu,
    before it reads a file or opens a socket."""
    import importlib

    tool = importlib.import_module(f"omniswarm_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(TOOLS[name])


@pytest.mark.parametrize("name", sorted(HOST_TOOLS))
def test_host_tools_run_without_cuda(monkeypatch, tmp_path, name):
    """The host-only tools take no --device and start without CUDA."""
    import importlib

    tool = importlib.import_module(f"omniswarm_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = HOST_TOOLS[name]
    if name == "fit_pca":
        desc = tmp_path / "d.npy"
        np.save(desc, np.random.default_rng(0).normal(size=(32, 8)))
        args = ["--desc", str(desc), *args]
    if name == "convert_superpoint":
        pth = tmp_path / "sp.pth"
        torch.save(tool.seeded_twin(0).state_dict(), pth)
        args = ["--pth", str(pth), "--out", str(tmp_path / "sp.npz")]
    with pytest.raises(SystemExit):
        tool.main([*args, "--device", "cpu"])
    assert tool.main(args) is not None


def test_cv2_only_inside_the_jpeg_codec():
    """OpenCV is imported by encode_image / decode_image alone, when called
    (the card's machine has none)."""
    found = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        owner = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    owner.setdefault(node, fn.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and any(
                    a.name.split(".")[0] == "cv2" for a in node.names):
                found.append((path.name, owner.get(node)))
    assert sorted(found) == [("comm.py", "decode_image"),
                             ("comm.py", "encode_image")]


def test_dense_graph_to_torch_roundtrip():
    data = sim.generate(sim.SimParams(num_drones=3, num_frames=12, seed=4))
    jg = jax.device_put(jdense.dense_graph_from_sim(
        data, ant_pos=np.ones((3, 3), np.float32)))
    tg = dense_graph_to_torch(jg, "cpu")
    assert isinstance(tg, DenseGraph)
    for name in DenseGraph._fields:
        a, b = getattr(jg, name), getattr(tg, name)
        pairs = zip(a, b) if name == "loops" else [(a, b)]
        for x, y in pairs:
            assert isinstance(y, torch.Tensor), name
            np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                          err_msg=name)
    assert tg.loops.frame_a.dtype == torch.int64


def test_warm_state_to_torch_nested():
    warm = ((jnp.ones((4, 8, 8)), jnp.zeros((2, 8, 8))), jnp.eye(16),
            np.full((12, 12), 2.0))
    got = warm_state_to_torch(warm, "cpu")
    assert len(got) == 3 and len(got[0]) == 2
    assert got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), warm[2])
