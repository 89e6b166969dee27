"""The 10-drone tier of ``tests/test_scale10.py`` on the port: the frame
packing rule at m = 40, a 10 x 30 window solved to the reference's bars and
to the JAX package's cost on the same inputs, and the pack-1 and pack-2
solves of 10 x 48 against each other and against JAX.

The JAX solves run in a fresh interpreter, as the reference's test runs its
D=10 solves (tests/test_scale10.py:48-70: late in a full suite this compile
has crashed XLA-CPU); it starts first and works while the port solves.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch import sim as tsim
from omniswarm_torch.eval import metrics as tmetrics
from omniswarm_torch.solver import dense as tdense
from omniswarm_tpu import sim
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RTOL_JAX = 1e-4          # port against JAX on the same inputs
PACK_RTOL = 5e-3         # pack 1 against pack 2 (tests/test_scale10.py:73)
# name: (seed, frames, solver keywords). The 10 x 48 solves run all 20
# iterations (function_tolerance 0): near its minimum an accepted step there
# lowers the cost by about 1e-6 relative, so the default tolerance's stop
# falls on a rounding tie (the port stopped after 10 iterations and JAX
# after 20 with their costs 5e-6 apart at 10)
SOLVES = {
    "d10_30": (4, 30, dict(max_iterations=60)),
    "pack1": (6, 48, dict(max_iterations=20, pack=1, function_tolerance=0.0)),
    "pack2": (6, 48, dict(max_iterations=20, pack=2, function_tolerance=0.0)),
}
ORACLE = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from omniswarm_tpu import sim
from omniswarm_tpu.solver.dense import dense_graph_from_sim, lm_solve_bt
out = {}
for name, (seed, F, kw) in json.loads(sys.argv[1]).items():
    data = sim.generate(sim.SimParams(num_drones=10, num_frames=F, seed=seed))
    r = lm_solve_bt(dense_graph_from_sim(data),
                    jnp.asarray(data.vio, jnp.float32), **kw)
    out[name] = dict(cost=float(r.cost), initial_cost=float(r.initial_cost),
                     iterations=int(r.iterations))
print("ORACLE", json.dumps(out))
"""


@pytest.mark.parametrize("F,m,want", [(512, 40, 2), (512, 20, 4),
                                      (512, 80, 1), (100, 20, 2),
                                      (100, 40, 1), (64, 20, 1)])
def test_auto_pack(F, m, want):
    """F >= 384 at D=10 packs 2 frames a block (80 wide), not 4; mid
    windows pack 2 at m <= 20; tiny windows stay unpacked."""
    assert tdense._auto_pack(F, m) == jdense._auto_pack(F, m) == want


@pytest.mark.parametrize("D,F,seed,loop_every", [(10, 192, 0, 5),
                                                  (5, 192, 4, 2)])
def test_simulator_loops_match_reference(D, F, seed, loop_every):
    """The port's proximity loops (nearest candidates picked from all the
    distances at once) choose the reference's pairs and draw the same
    noise, at 10 drones and at the loop-dense stride."""
    ref = sim.generate(sim.SimParams(num_drones=D, num_frames=F, seed=seed,
                                     loop_every=loop_every))
    got = tsim.generate(tsim.SimParams(num_drones=D, num_frames=F,
                                       seed=seed, loop_every=loop_every))
    assert len(got.loops) == len(ref.loops) > F // loop_every
    for lr, lg in zip(ref.loops, got.loops):
        for f in dataclasses.fields(lr):
            assert np.array_equal(getattr(lr, f.name), getattr(lg, f.name))
    assert np.array_equal(got.vio, ref.vio)


@pytest.fixture(scope="module")
def oracle_proc():
    proc = subprocess.Popen(
        [sys.executable, "-c", ORACLE, json.dumps(SOLVES)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port(oracle_proc):
    out = {}
    for name, (seed, F, kw) in SOLVES.items():
        data = sim.generate(sim.SimParams(num_drones=10, num_frames=F,
                                          seed=seed))
        res = tdense.lm_solve_bt(jdense.dense_graph_from_sim(data), data.vio,
                                 device="cpu", **kw)
        out[name] = (data, res)
    return out


@pytest.fixture(scope="module")
def oracle(oracle_proc, port):
    stdout, stderr = oracle_proc.communicate(timeout=600)
    assert oracle_proc.returncode == 0, stderr[-2000:]
    line = next(ln for ln in stdout.splitlines() if ln.startswith("ORACLE"))
    return json.loads(line.split(" ", 1)[1])


def test_ten_drone_window_converges(port, oracle):
    """tests/test_scale10.py:15-25 on the port, and the JAX cost."""
    data, res = port["d10_30"]
    cost, want = float(res.cost), oracle["d10_30"]
    assert np.isfinite(cost) and cost < float(res.initial_cost)
    np.testing.assert_allclose(float(res.initial_cost), want["initial_cost"],
                               rtol=RTOL_JAX)
    np.testing.assert_allclose(cost, want["cost"], rtol=RTOL_JAX)
    rel = tmetrics.mean_relative_ate(res.poses.numpy(), data.gt)
    rel_vio = tmetrics.mean_relative_ate(data.vio, data.gt)
    assert rel < rel_vio * 0.7, (rel, rel_vio)
    assert rel < 0.15, rel


@pytest.mark.parametrize("name", ["pack1", "pack2"])
def test_packed_solve_matches_jax(port, oracle, name):
    """10 x 48 at pack 1 and pack 2 (the 80-wide blocks): each within
    1e-4 of JAX's solve of the same pack, and of the other pack within the
    reference's 5e-3 (tests/test_scale10.py:71-74)."""
    costs = {k: float(port[k][1].cost) for k in ("pack1", "pack2")}
    assert all(np.isfinite(c) for c in costs.values())
    np.testing.assert_allclose(costs[name], oracle[name]["cost"],
                               rtol=RTOL_JAX)
    assert port[name][1].iterations == oracle[name]["iterations"] == 20
    assert abs(costs["pack1"] - costs["pack2"]) / costs["pack1"] < PACK_RTOL
