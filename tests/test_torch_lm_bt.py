"""Port vs reference: the whole LM solve on the tests/test_bt_lm.py problem
(D=4, F=20, seed 31), compared near convergence (20 iterations,
function_tolerance=0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.eval import metrics as tmetrics
from omniswarm_torch.solver import dense as tdense
from omniswarm_torch.solver import fused_level as tfl
from omniswarm_tpu import sim
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
ITERS = 20


@pytest.fixture(scope="module")
def problem():
    data = sim.generate(sim.SimParams(num_drones=4, num_frames=20, seed=31))
    return data, jdense.dense_graph_from_sim(data)


# pack=2 with fused=True sends every warm level through the port's fused
# dispatch (its plain version on CPU); the reference never fuses on CPU, so
# the port's fused solve is held against the unfused reference
@pytest.mark.parametrize("pack,fused,per_iter", [(1, None, 0), (2, True, 2)])
def test_lm_solve_bt_matches_jax(problem, pack, fused, per_iter):
    data, graph = problem
    ref = jdense.lm_solve_bt(graph, jnp.asarray(data.vio, jnp.float32),
                             max_iterations=ITERS, function_tolerance=0.0,
                             pack=pack)
    calls, launches = (tfl.fused_reduction_level_ref.calls,
                       tfl.fused_reduction_level.launches)
    got = tdense.lm_solve_bt(graph, data.vio, device="cpu",
                             max_iterations=ITERS, function_tolerance=0.0,
                             pack=pack, fused=fused)
    assert got.iterations == int(ref.iterations) == ITERS
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)
    poses = got.poses.numpy()
    assert tmetrics.mean_relative_ate(poses, np.asarray(ref.poses)) < 5e-3
    assert tmetrics.mean_relative_ate(poses, data.gt) < 0.08
    assert tfl.fused_reduction_level.launches == launches
    # 10 packed blocks pad to 16: levels 16 -> 8 -> 4, two per warm factor
    assert tfl.fused_reduction_level_ref.calls - calls == per_iter * ITERS


@pytest.mark.parametrize("kw", [dict(exact_linear=True), dict(linear="pcg")],
                         ids=["exact", "pcg"])
def test_lm_solve_bt_linear_paths_match_jax(problem, kw):
    """The exact-Woodbury and the PCG paths against the reference's, and
    PCG within the reference test's bars of the Woodbury solve
    (tests/test_bt_lm.py:87-99): cost within 5e-3, relative ATE < 0.02."""
    data, graph = problem
    ref = jdense.lm_solve_bt(graph, jnp.asarray(data.vio, jnp.float32),
                             max_iterations=50, **kw)
    got = tdense.lm_solve_bt(graph, data.vio, device="cpu",
                             max_iterations=50, **kw)
    assert np.isfinite(float(got.cost))
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)
    poses = got.poses.numpy()
    assert tmetrics.mean_relative_ate(poses, np.asarray(ref.poses)) < 5e-3
    assert tmetrics.mean_relative_ate(poses, data.gt) < 0.08
    smw = tdense.lm_solve_bt(graph, data.vio, device="cpu",
                             max_iterations=50, linear="smw")
    np.testing.assert_allclose(float(got.cost), float(smw.cost), rtol=5e-3)
    assert tmetrics.mean_relative_ate(poses, smw.poses.numpy()) < 0.02


def test_linear_auto_rule(problem, monkeypatch):
    """"auto" takes PCG once 4L > 4096 (here 1,025 loop slots), never with
    exact_linear, and the Woodbury path below that."""
    data, _ = problem
    big = jdense.dense_graph_from_sim(data, max_loops=1025)
    calls = []
    for name in ("_pcg_solve_core", "_smw_solve_core"):
        fn = getattr(tdense, name)
        monkeypatch.setattr(tdense, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    kw = dict(device="cpu", max_iterations=2, cg_iters=3)
    tdense.lm_solve_bt(big, data.vio, **kw)
    assert set(calls) == {"_pcg_solve_core"}
    calls.clear()
    tdense.lm_solve_bt(big, data.vio, exact_linear=True, **kw)
    assert set(calls) == {"_smw_solve_core"}
    calls.clear()
    tdense.lm_solve_bt(problem[1], data.vio, **kw)
    assert set(calls) == {"_smw_solve_core"}
