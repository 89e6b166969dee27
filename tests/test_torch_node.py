"""The decentralized system of ``tests/test_decentralized.py`` in both
packages: 3 DroneNodes x 25 frames over a lossy bus, each node's detector
drawing the reference's random numbers (``use_jax_draws``). The loops found
and received must be equal loop for loop, per-drone costs within 1%, and the
port must meet the reference test's bars.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch.config import FrontendParams as TFrontendParams
from omniswarm_torch.config import SolverParams as TSolverParams
from omniswarm_torch.eval import metrics as tmetrics
from omniswarm_torch.sim.visual_world import VisualWorld as TVisualWorld
from omniswarm_torch.swarm.comm import LossyBus as TLossyBus
from omniswarm_torch.swarm.estimator import loop_key as tloop_key
from omniswarm_torch.swarm.node import DroneNode as TDroneNode
from omniswarm_tpu import sim
from omniswarm_tpu.config import FrontendParams, SolverParams
from omniswarm_tpu.sim.visual_world import VisualWorld
from omniswarm_tpu.swarm.comm import LossyBus
from omniswarm_tpu.swarm.estimator import loop_key
from omniswarm_tpu.swarm.node import DroneNode

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_loop_detector import use_jax_draws  # noqa: E402

torch.set_num_threads(1)
D, F = 3, 25
FP = dict(max_db_size=512, min_loop_matches=12, match_index_dist=5,
          netvlad_thres=0.5, pnp_iterations=128)
SP = dict(pcm_redundant=False, max_iterations=60, init_z_movement=0.05)


def run_system(port: bool, data):
    if port:
        world = TVisualWorld(seed=7, n_landmarks=600, extent=8.0)
        bus = TLossyBus(drop_rate=0.05, seed=3)
        nodes = [TDroneNode(d, bus, solver_params=TSolverParams(**SP),
                            frontend_params=TFrontendParams(**FP),
                            global_dim=world.global_dim, seed=d,
                            device="cpu") for d in range(D)]
        for d, node in enumerate(nodes):
            use_jax_draws(node.detector, d)
    else:
        world = VisualWorld(seed=7, n_landmarks=600, extent=8.0)
        bus = LossyBus(drop_rate=0.05, seed=3)
        nodes = [DroneNode(d, bus, solver_params=SolverParams(**SP),
                           frontend_params=FrontendParams(**FP),
                           global_dim=world.global_dim, seed=d)
                 for d in range(D)]
    for k in range(F):
        t = float(data.times[k])
        vio = {d: data.vio[k, d] for d in range(D)}
        ranges = {(a, b): float(data.ranges[k, a, b])
                  for a in range(D) for b in range(D)
                  if a != b and data.range_valid[k, a, b]}
        for node in nodes:
            node.on_swarm_frame(t, vio, ranges)
        if k % 2 == 0:
            for d, node in enumerate(nodes):
                node.on_local_keyframe(world.make_keyframe(
                    d, k, data.gt[k, d], t, vio_pose=data.vio[k, d]), t)
        bus.step(t + 0.01)
        for node in nodes:
            node.step(t + 0.02)
    return nodes, [node.solve() for node in nodes]


@pytest.fixture(scope="module")
def systems():
    data = sim.generate(sim.SimParams(
        num_drones=D, num_frames=F, seed=51,
        radius_range=(2.0, 4.0), z_range=(0.8, 2.0)))
    return data, run_system(False, data), run_system(True, data)


def test_loops_equal(systems):
    _data, (ref, _), (port, _) = systems
    for r, p in zip(ref, port):
        assert p.loops_found == r.loops_found
        assert p.loops_received == r.loops_received
        want = {loop_key(lp): lp for lp in r.estimator.loops}
        got = {tloop_key(lp): lp for lp in p.estimator.loops}
        assert set(got) == set(want)
        for key, lp in want.items():
            np.testing.assert_allclose(got[key].dpose, lp.dpose, atol=1e-4)
    assert sum(n.loops_found for n in port) >= 2
    assert sum(n.loops_received for n in port) >= \
        sum(n.loops_found for n in port)


def test_costs_and_accuracy(systems):
    data, (ref, ref_out), (port, port_out) = systems
    for r, p, ro, po in zip(ref, port, ref_out, port_out):
        assert po["solved"] and ro["solved"]
        assert p.estimator.finish_init
        assert po["cost"] == pytest.approx(ro["cost"], rel=0.01)
        assert p.estimator.pair_inliers.keys() == r.estimator.pair_inliers.keys()
        kf_idx = [int(round(kf.t)) for kf in p.estimator.window]
        rel = tmetrics.mean_relative_ate(p.estimator.estimate,
                                         data.gt[kf_idx])
        assert rel < 0.10, (p.drone_id, rel)


def test_nodes_agree_on_relative_state(systems):
    _data, _ref, (port, _) = systems
    ests = []
    for node in port[:2]:
        est = node.estimator
        ids = est.window_ids
        ests.append(est.estimate[-1, ids.index(1), :3]
                    - est.estimate[-1, ids.index(0), :3])
    assert np.linalg.norm(ests[0] - ests[1]) < 0.5
