"""Port vs reference: the frame-sharded SPIKE block-tridiagonal solve
(tests/test_bt_spike.py's cases) on gloo ranks spawned on the CPU at worlds
4, 2 and 1, against the port's single-process bt_solve and the JAX
spike_solve on 4 virtual devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from omniswarm_torch.parallel.bt_spike import pad_for_mesh
from omniswarm_torch.parallel.launch import call_each, run_ranks
from omniswarm_torch.solver.block_tridiag import bt_matvec, bt_solve
from omniswarm_tpu.parallel import bt_spike as jspike

torch.set_num_threads(1)
SOLVE = "omniswarm_torch.parallel.bt_spike:spike_solve"
CASES = [(64, 8, 5), (128, 12, 3), (96, 8, 1)]
WORLDS = (4, 2)


def random_spd_bt(F, m, K, seed=0):
    """SPD block-tridiagonal system: T = chain J^T J + diagonal boost
    (tests/test_bt_spike.py's), as f32 numpy."""
    rng = np.random.default_rng(seed)
    A = np.zeros((F, m, m), np.float64)
    B = rng.normal(0, 0.3, size=(F - 1, m, m))
    for f in range(F):
        Q = rng.normal(size=(m, m))
        A[f] = Q @ Q.T / m + 3.0 * np.eye(m)
    for f in range(F - 1):
        s = np.abs(B[f]).sum()
        A[f] += np.eye(m) * s / m
        A[f + 1] += np.eye(m) * s / m
    rhs = rng.normal(size=(F, m, K))
    return tuple(x.astype(np.float32) for x in (A, B, rhs))


def rel_err(x, ref):
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def port_bt_solve(A, B, rhs):
    return bt_solve(*map(torch.from_numpy, (A, B, rhs))).numpy()


@pytest.fixture(scope="module")
def runs():
    """Every case inside one spawn of 4 gloo ranks (world 2 and 1 in
    blocks of the 4): {world: [the calls of each rank, as ``problems``],
    1: [the degenerate call of each rank]}."""
    problems = [random_spd_bt(F, m, K, seed=F + m) for F, m, K in CASES]
    problems.append(random_spd_bt(64, 8, 4, seed=3))      # residual case
    padding = random_spd_bt(50, 8, 3, seed=9)              # 50 % 4 != 0
    single = random_spd_bt(32, 8, 2, seed=5)
    calls = []
    for world in WORLDS:
        A, Bp, rhs, _ = pad_for_mesh(*map(torch.from_numpy, padding), world)
        calls += [(SOLVE, dict(A=A, B=B, rhs=rhs), world)
                  for A, B, rhs in problems]
        calls.append((SOLVE, dict(A=A.numpy(), B=Bp.numpy(),
                                  rhs=rhs.numpy()), world))
    calls.append((SOLVE, dict(zip(("A", "B", "rhs"), single)), 1))
    ranks = run_ranks(call_each, 4, backend="gloo", device="cpu",
                      args=(calls,), timeout_s=300)
    n = len(problems) + 1
    out = {world: [r[i * n:(i + 1) * n] for r in ranks]
           for i, world in enumerate(WORLDS)}
    out[1] = [r[-1] for r in ranks]
    return dict(out, problems=problems, padding=padding, single=single)


@pytest.fixture(scope="module")
def jax_spike(runs):
    """The reference's spike_solve of each case on 4 virtual devices."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("frames",))
    return [np.asarray(jspike.spike_solve(*map(jnp.asarray, p), mesh))
            for p in runs["problems"][:len(CASES)]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_spike_matches_bt_solve(runs, jax_spike, world, case):
    A, B, rhs = runs["problems"][case]
    ranks = runs[world]
    x = ranks[0][case]["result"]
    for r in ranks[1:]:                  # every rank returns the whole x
        np.testing.assert_array_equal(r[case]["result"], x)
    assert rel_err(x, port_bt_solve(A, B, rhs)) < 2e-4
    assert rel_err(x, jax_spike[case]) < 2e-4


@pytest.mark.parametrize("world", WORLDS)
def test_spike_residual_exact(runs, world):
    A, B, rhs = runs["problems"][-1]
    x = runs[world][0][len(CASES)]["result"]
    r = bt_matvec(*map(torch.from_numpy, (A, B, x))).numpy() - rhs
    assert float(np.max(np.abs(r)) / np.max(np.abs(rhs))) < 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_spike_padding(runs, world):
    A, B, rhs = runs["padding"]
    x = runs[world][0][-1]["result"]
    assert x.shape[0] == -(-50 // world) * world and not np.any(x[50:])
    assert rel_err(x[:50], port_bt_solve(A, B, rhs)) < 2e-4


def test_spike_single_shard_degenerate(runs):
    A, B, rhs = runs["single"]
    for call in runs[1]:
        assert rel_err(call["result"], port_bt_solve(A, B, rhs)) < 1e-5
        # the cyclic permute of one rank is the identity: counted, no
        # transport
        assert call["counts"]["send_next"]["calls"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_spike_collectives(runs, world):
    """One neighbour exchange of the m x m coupling block and ONE fused
    all-gather of the tips and boundary rows a solve, then the gather of
    the output."""
    F, m, K = CASES[0]
    counts = runs[world][0][0]["counts"]
    assert counts == {
        "send_next": {"calls": 1, "bytes": 4 * m * m},
        "all_gather": {"calls": 1,
                       "bytes": 4 * world * (4 * m * m + 2 * m * K)},
        "all_gather/output": {"calls": 1, "bytes": 4 * F * m * K}}
    assert runs[world][0][0]["kernels"]["k1"] == 0
