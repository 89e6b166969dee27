"""Stage times of one LM iteration of ``lm_solve_bt`` over the window size.

    python -m omniswarm_torch.tools.profile_fscale [--frames 128,256,512,1024]
        [--stages assemble,smw,iter] [--reps 30] [--pack 1]
        [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/profile_fscale.py``: at each F, 5 drones (seed 1,
loop density of the reference's rule: ``loop_every`` 5 up to F=128, 128
from F=1024, 5F/100 between) and each stage of ``--stages`` timed alone
(``benchutil.stage_ms``, ``--reps`` calls, each warm-started from
the one before):

- ``assemble``: ``assemble_blocks`` (``assemble_ms``);
- ``factor``: the warm ``bt_factor`` of the damped blocks unpacked
  (``factor_warm_ms``), and packed at ``_auto_pack`` (the solve's own
  choice) with its warm levels through K1 (``factor_packed_fused_ms``) and
  through the plain level (``factor_packed_unfused_ms``);
- ``apply``: ``bt_apply`` of the gradient column (``apply_g_ms``) and of
  the C bf16 loop columns (``apply_U_ms``), and the capacitance, its
  inverse and the correction (``S_cap_corr_ms``);
- ``smw``: the warm ``_smw_solve_core`` at ``--pack``, unfused levels as
  the reference times it (``smw_warm_ms``);
- ``iter``: assembly and the warm solve (``iter_warm_ms``).

Prints one JSON list of rows (``F``, ``C``, ``loops`` and the stage keys;
``pack_packed`` and ``k1_launches_per_factor`` with the factor stage).
"""
from __future__ import annotations

import argparse
import json

import torch

from omniswarm_torch.benchutil import (chain, k1_levels, nudge,
                                       sim_problem, stage_ms)
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver.block_tridiag import (bt_apply, bt_factor,
                                                  bt_warm_state, pack_bt_mats,
                                                  spd_ns_inverse)
from omniswarm_torch.solver.dense import (_auto_pack, _damped,
                                          _smw_solve_core, assemble_blocks)

STAGES = ("assemble", "factor", "apply", "smw", "iter")


def loop_every_for(F: int) -> int:
    """The reference's loop-density rule (tools/profile_fscale.py:47)."""
    return 5 if F <= 128 else (128 if F >= 1024 else 5 * F // 100)


@highp()
def profile_F(F: int, stages, reps: int, dev, pack: int = 1) -> dict:
    """One row: the stage times at window size F (module docstring)."""
    data, graph, init, _ = sim_problem(dev, num_drones=5, num_frames=F,
                                       seed=1, loop_every=loop_every_for(F))
    A0, B0, g0, U0, _ = assemble_blocks(graph, init)
    C, m = U0.shape[-1], A0.shape[-1]
    print(f"F={F} loops={len(data.loops)} C={C} m={m}", flush=True)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    Ub = U0.to(torch.bfloat16)
    res = {"F": F, "C": int(C), "loops": len(data.loops)}
    Ad0 = _damped(A0, torch.sum(U0 * U0, -1), 1e-4)

    if "assemble" in stages:
        res["assemble_ms"] = stage_ms(
            f"F={F} assemble",
            chain(lambda p: nudge(p, assemble_blocks(graph, p)[2]), init),
            reps)

    if "factor" in stages:
        def factor_chain(A, B, pk, fused):
            fac0 = bt_factor(A, B, ns_iters=8 if pk == 1 else 12,
                             direct_threshold=4)
            return chain(lambda w: bt_warm_state(bt_factor(
                A, B, ns_iters=8, direct_threshold=4, warm=w,
                fused=fused)), bt_warm_state(fac0))
        res["factor_warm_ms"] = stage_ms(f"F={F} bt_factor warm",
                                         factor_chain(Ad0, B0, 1, False),
                                         reps)
        pk = _auto_pack(F, m)
        Adp, Bp, _ = pack_bt_mats(Ad0, B0, pk)
        res["pack_packed"] = pk
        res["factor_packed_unfused_ms"] = stage_ms(
            f"F={F} bt_factor warm pack {pk}",
            factor_chain(Adp, Bp, pk, False), reps)
        fused = factor_chain(Adp, Bp, pk, True)
        with k1_levels() as levels:
            fused()
        res["k1_launches_per_factor"] = len(levels)
        res["factor_packed_fused_ms"] = stage_ms(
            f"F={F} bt_factor warm pack {pk} fused", fused, reps)

    if "apply" in stages:
        fac0 = bt_factor(Ad0, B0, ns_iters=8, direct_threshold=4)
        res["apply_g_ms"] = stage_ms(
            f"F={F} bt_apply g (1 col)",
            chain(lambda g: nudge(g, bt_apply(fac0, -g[..., None])), g0),
            reps)
        res["apply_U_ms"] = stage_ms(f"F={F} bt_apply U ({C} col bf16)",
                                     lambda: bt_apply(fac0, Ub), reps)
        YU = bt_apply(fac0, Ub).float().reshape(-1, C)
        Uf = Ub.float().reshape(-1, C)

        def s_cap_corr(yb):
            S = torch.eye(C, device=dev) + Uf.mT @ YU
            Uyb = Uf.mT @ yb.reshape(-1)
            Xf = spd_ns_inverse(S, None)
            z = Xf @ Uyb
            for _ in range(2):
                z = z + Xf @ (Uyb - S @ z)
            return nudge(yb, yb.reshape(-1) - YU @ z)
        yb0 = bt_apply(fac0, -g0[..., None])[..., 0]
        res["S_cap_corr_ms"] = stage_ms(f"F={F} S+cap+corr",
                                        chain(s_cap_corr, yb0), reps)

    def smw(A, B, g, U, w):
        return _smw_solve_core(A, B, g, U, lam, w, pack=pack)

    if "smw" in stages:
        def smw_step(carry):
            g, w = carry
            dx, w = smw(A0, B0, g, Ub, w)
            return nudge(g, dx), w
        res["smw_warm_ms"] = stage_ms(
            f"F={F} smw warm",
            chain(smw_step, (g0, smw(A0, B0, g0, Ub, None)[1])), reps)

    if "iter" in stages:
        def iter_step(carry):
            p, w = carry
            A, B, g, U, _ = assemble_blocks(graph, p)
            dx, w = smw(A, B, g, U.to(torch.bfloat16), w)
            return nudge(p, dx), w
        res["iter_warm_ms"] = stage_ms(
            f"F={F} full iter warm",
            chain(iter_step, (init, smw(A0, B0, g0, Ub, None)[1])), reps)
    return res


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.profile_fscale",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", default="128,256,512,1024")
    ap.add_argument("--stages", default="assemble,smw,iter",
                    help=f"comma-separated, of {','.join(STAGES)}")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--pack", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    stages = set(args.stages.split(","))
    if stages - set(STAGES):
        ap.error(f"unknown stages {sorted(stages - set(STAGES))}")
    dev = resolve_device(args.device)
    with torch.no_grad():
        rows = [profile_F(int(F), stages, args.reps, dev, args.pack)
                for F in args.frames.split(",")]
    print(json.dumps(rows), flush=True)
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
