"""The port's solver tools (``omniswarm_torch/tools/``) against the JAX
package's ``lm_solve_bt`` on the same problems, at small sizes on the CPU:
the window-scale sweep's rows hold the reference's final cost,
``profile_f100``'s grid holds its costs, and the profile tools report the
reference tools' keys (the dense-loop tool: ``test_torch_tools_dense.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.tools import (profile_f100, profile_fleet,
                                   profile_fscale, profile_solver,
                                   window_scale_sweep)
from omniswarm_tpu import sim
from omniswarm_tpu.solver import dense as jdense

torch.set_num_threads(1)
ITERS = 3
CPU = torch.device("cpu")


def jax_solve(params, iters=ITERS, **kw):
    data = sim.generate(sim.SimParams(**params))
    return jdense.lm_solve_bt(jdense.dense_graph_from_sim(data),
                              jnp.asarray(data.vio, jnp.float32),
                              max_iterations=iters, function_tolerance=0.0,
                              **kw)


@pytest.mark.parametrize("F,reps", [(128, 1), (256, 0)])
def test_window_scale_row_matches_jax(F, reps):
    row = window_scale_sweep.sweep_row(F, CPU, iters=ITERS, reps=reps,
                                       repeat=True)
    ref = jax_solve(dict(num_drones=5, num_frames=F, seed=1,
                         loop_every=128))
    assert {"frames", "loops", "ms_per_iter", "iter_per_s",
            "pose_updates_per_s", "first_solve_s"} <= set(row)
    assert row["frames"] == F and row["iterations"] == ITERS
    assert row["loops"] == int(np.asarray(
        jdense.dense_graph_from_sim(sim.generate(sim.SimParams(
            num_drones=5, num_frames=F, seed=1,
            loop_every=128))).loops.valid).sum())
    np.testing.assert_allclose(row["initial_cost"], float(ref.initial_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(row["final_cost"], float(ref.cost), rtol=1e-3)
    assert row["repeat_equal"] and row["linear"] == "smw"
    assert row["pack"] == 2 and row["k1_launches"] == 0
    np.testing.assert_allclose(row["pose_updates_per_s"],
                               row["iter_per_s"] * F * 5)
    assert row["relative_ate"] < row["vio_relative_ate"]


def test_profile_f100_grid_matches_jax():
    """The packed rows against the reference's costs at each pack. At pack
    1 the warm Newton-Schulz Woodbury step lies 122% from the exact step in
    both packages, so the first iterations split on rounding: the
    reference's own eager and jitted first steps reach 614.80 and 191.49
    (the port 614.81); the two packages meet again near the minimum (within
    4e-4 at the tool's 100 iterations). That row is held to a finite cost
    below the initial one, and its cost_delta to the port's own costs."""
    res = profile_f100.grid("cpu", iters=ITERS, reps=0)
    want = {"single_pack1", "single_pack2", "single_pack2_fused",
            "single_pack4", "single_pack4_fused", "batch8_pack1",
            "batch8_pack2", "batch8_pack4"}
    assert want <= set(res)
    params = dict(num_drones=5, num_frames=100, seed=0)
    ref = {p: jax_solve(params, pack=p) for p in (2, 4)}
    base = res["single_pack1"]["cost"]
    assert np.isfinite(base) and base < float(ref[2].initial_cost)
    for key, row in res.items():
        if not key.startswith("single"):
            continue
        pack = int(key.split("pack")[1][0])
        if pack > 1:
            np.testing.assert_allclose(row["cost"], float(ref[pack].cost),
                                       rtol=1e-3, err_msg=key)
        np.testing.assert_allclose(row["cost_delta"],
                                   abs(row["cost"] - base) / base)
        assert row["k1_launches"] == 0
    assert all(res[f"batch8_pack{p}"]["aggregate_iter_per_s"] > 0
               for p in (1, 2, 4))


def test_profile_fscale_keys():
    (row,) = profile_fscale.main(["--device", "cpu", "--frames", "128",
                                  "--reps", "1", "--stages",
                                  ",".join(profile_fscale.STAGES)])
    assert {"F", "C", "loops", "assemble_ms", "factor_warm_ms",
            "apply_g_ms", "apply_U_ms", "S_cap_corr_ms", "smw_warm_ms",
            "iter_warm_ms", "factor_packed_fused_ms",
            "factor_packed_unfused_ms"} <= set(row)
    assert row["F"] == 128 and row["C"] == 4 * row["loops"]
    assert row["pack_packed"] == 2 and row["k1_launches_per_factor"] == 0
    assert profile_fscale.loop_every_for(128) == 5
    assert profile_fscale.loop_every_for(512) == 25
    assert profile_fscale.loop_every_for(1024) == 128


def test_profile_solver_and_fleet_keys():
    out = profile_solver.profile("cpu", reps=1)
    assert set(out) == {"assemble_ms", "smw_cold_ms", "smw_warm_ms",
                        "assemble_smw_cold_ms", "assemble_smw_warm_ms",
                        "factor_ms", "factor_apply_g_ms",
                        "factor_apply_U_ms", "factor_apply_S_ms"}
    fleet = profile_fleet.profile("cpu", reps=1)
    assert set(fleet) == {"cap", "assemble_shared_ms", "assemble_stacked_ms",
                          "smw_ms", "iter_stacked_ms", "iter_shared_ms"}
    assert fleet["cap"] % 16 == 0
    assert all(v > 0 for v in {**out, **fleet}.values())


def test_tools_need_a_device_choice():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        window_scale_sweep.sweep("cuda", frames=(128,), iters=1)
