"""The collective contract of the port's multi-device layouts, read from
the Axis counters on 4 gloo ranks spawned on the CPU (the counterpart of
tests/test_comm_contract.py, which pins the JAX programs' HLO).

Per LM iteration of the frame-sharded window (F=64, D=4, seed 2,
loop_every=16, tools/comm_model.py's problem): 2 permutes (the packed halo
and the packed boundary), 2 all-gathers (the poses for the loop endpoints,
the fused SPIKE tips) and 2 all-reduces. JAX's one-iteration program has
one all-reduce: XLA groups the capacitance with the cost, which that
program does not use. The LM loop must decide accept on the reduced cost,
which exists only after the next assembly, so the port reduces
``[S | U^T y_b]`` and then ``[cost | bad]``; the second also carries the
step's failure flag, the reference loop's separate ``pmax``.
"""
import numpy as np
import pytest
import torch

from omniswarm_torch import sim
from omniswarm_torch.parallel.launch import call_each, run_ranks
from omniswarm_torch.sim.pipeline import build_graph_from_sim
from omniswarm_torch.solver.dense import dense_graph_from_sim

torch.set_num_threads(1)
PAR = "omniswarm_torch.parallel"
WORLD = 4


@pytest.fixture(scope="module")
def window():
    data = sim.generate(sim.SimParams(num_drones=4, num_frames=64, seed=2,
                                      loop_every=16))
    return data, dense_graph_from_sim(data)


@pytest.fixture(scope="module")
def runs(window):
    data, graph = window
    small = sim.generate(sim.SimParams(num_drones=4, num_frames=24, seed=7))
    fgraph, finit = build_graph_from_sim(small, enable_detections=True)
    lanes = [sim.generate(sim.SimParams(num_drones=3, num_frames=16,
                                        seed=100 + s)) for s in range(8)]
    lgraphs = [dense_graph_from_sim(d, max_loops=32) for d in lanes]
    linits = [d.vio for d in lanes]
    win = dict(graph=graph, poses0=data.vio, function_tolerance=0.0)
    calls = [(f"{PAR}.sharded_window:lm_solve_bt_sharded",
              dict(win, max_iterations=n)) for n in (1, 3)]
    calls.append((f"{PAR}.sharded_solver:sharded_lm_solve",
                  dict(graph=fgraph, poses0=finit, max_iterations=3,
                       function_tolerance=0.0)))
    calls += [(f"{PAR}.swarm_batch:solve_fleet",
               dict(graphs=lgraphs[:n], inits=linits[:n], max_iterations=5))
              for n in (8, 6)]
    ranks = run_ranks(call_each, WORLD, backend="gloo", device="cpu",
                      args=(calls,), timeout_s=300)
    for r in ranks[1:]:                  # the same collectives on every rank
        assert [c["counts"] for c in r] == [c["counts"] for c in ranks[0]]
    return dict(zip(("win1", "win3", "factors", "fleet8", "fleet6"),
                    ranks[0]))


def per_iteration(runs):
    """The window's counters of 3 iterations less those of 1, halved."""
    a, b = runs["win1"]["counts"], runs["win3"]["counts"]
    assert runs["win1"]["result"].iterations == 1
    assert runs["win3"]["result"].iterations == 3
    return {k: {f: (b[k][f] - a.get(k, {f: 0})[f]) / 2 for f in b[k]}
            for k in b}


def test_frame_sharded_collective_count(runs):
    it = per_iteration(runs)
    calls = {k: v["calls"] for k, v in it.items() if v["calls"]}
    assert calls == {"send_next": 1, "recv_from_next": 1, "all_gather": 2,
                     "psum": 2}, calls
    # once per solve: the initial cost, the initial assembly's exchanges
    # and the final gather of the poses
    once = runs["win1"]["counts"]
    assert once["all_gather/output"]["calls"] == 1
    assert once["psum"]["calls"] == 3


def test_frame_sharded_collective_bytes(window, runs):
    """Exactly the analytic model of tests/test_comm_contract.py: the
    all-reduces carry the (C, C) capacitance, U^T y_b and [cost | bad],
    the all-gathers the poses and the fused SPIKE tips (f32)."""
    data, graph = window
    F, D = data.gt.shape[:2]
    C, m = 4 * graph.loops.valid.shape[0], 4 * D
    it = per_iteration(runs)
    assert it["psum"]["bytes"] == 4 * (C * C + C) + 4 * 2
    assert it["all_gather"]["bytes"] == (
        4 * F * D * 4 + 4 * WORLD * (4 * m * m + 2 * m * (1 + C)))
    assert it["recv_from_next"]["bytes"] == 4 * D * 7
    assert it["send_next"]["bytes"] == 4 * m * (2 * m + 1)
    assert it["send_next"]["bytes"] + it["recv_from_next"]["bytes"] \
        < 64 * 1024


def test_factor_sharded_one_all_reduce_per_assembly(runs):
    call = runs["factors"]
    n = 4 * 24 * 4                      # 4 parameters a pose
    assert call["result"].iterations == 3
    assert call["counts"] == {"psum": {"calls": 4,
                                       "bytes": 4 * 4 * (n * n + n + 2)}}


def test_fleet_layout_zero_data_collectives(runs):
    """No collective during the solve: with 8 lanes on 4 ranks only the
    one gather of the result, with 6 (replicated) none at all."""
    res = runs["fleet8"]["result"]
    B, F, D = res.poses.shape[:3]
    assert runs["fleet8"]["counts"] == {"all_gather/output": {
        "calls": 1, "bytes": 4 * (B * F * D * 4 + 3 * B + WORLD)}}
    assert runs["fleet6"]["counts"] == {}
    assert runs["fleet8"]["kernels"]["k1"] == 0
