"""The batched LM iteration at F=100, B=8: assembly against the Woodbury
solve.

    python -m omniswarm_torch.tools.profile_solver [--internals-only]
        [--device cuda|cpu]

Counterpart of ``tools/profile_solver.py``: 5 drones x 100 keyframes (seed
0), the batch of 8 inits of ``benchutil.batch_inits``, each stage timed
alone (``benchutil.stage_ms``, 50 calls, each fed from the
one before) on the lanes of ``lm_solve_bt_batched`` as it runs them, one
after another (unpacked Newton-Schulz Woodbury, ``_smw_solve_core`` at pack
1 as the reference times it):

- ``assemble_ms`` (``assemble_blocks`` of the 8 lanes), ``smw_cold_ms``,
  ``smw_warm_ms``, ``assemble_smw_cold_ms``, ``assemble_smw_warm_ms``;
- the internals (``--internals-only`` times only these): ``factor_ms``
  (``bt_factor``), ``factor_apply_g_ms`` (the factor and one gradient
  column), ``factor_apply_U_ms`` (the factor and the C bf16 loop columns),
  ``factor_apply_S_ms`` (the factor, the gradient column, the capacitance
  solve and the correction).

Prints a line a stage and one JSON object.
"""
from __future__ import annotations

import argparse
import json

import torch

from omniswarm_torch.benchutil import (batch_inits, chain, nudge,
                                       sim_problem, stage_ms)
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver.block_tridiag import (bt_apply, bt_factor,
                                                  spd_solve_approx)
from omniswarm_torch.solver.dense import (_damped, assemble_lanes,
                                          smw_lanes)


@highp()
def profile(device="cuda", reps: int = 50, internals_only: bool = False
            ) -> dict:
    """The stage times (see the module docstring)."""
    dev = resolve_device(device)
    _, graph, _, init_np = sim_problem(dev, num_drones=5, num_frames=100,
                                       seed=0)
    poses0 = torch.from_numpy(batch_inits(init_np)).to(dev)
    B = poses0.shape[0]
    lam = torch.full((B,), 1e-4, device=dev)

    def assemble(p):
        return assemble_lanes([graph] * B, p)

    def smw(A, Bo, g, U, warm):
        return smw_lanes(A, Bo, g, U.to(torch.bfloat16), lam, warm)

    A0, B0, g0, U0, _ = assemble(poses0)
    print("shapes: A", tuple(A0.shape), "B", tuple(B0.shape), "g",
          tuple(g0.shape), "U", tuple(U0.shape), flush=True)
    out, cold = {}, [None] * B

    if not internals_only:
        out["assemble_ms"] = stage_ms(
            "assemble_blocks (B=8)",
            chain(lambda p: nudge(p, assemble(p)[2]), poses0), reps)
        out["smw_cold_ms"] = stage_ms(
            "smw_solve cold (B=8)",
            chain(lambda g: nudge(g, smw(A0, B0, g, U0, cold)[0]), g0), reps)

        def smw_warm(carry):
            g, w = carry
            dx, w = smw(A0, B0, g, U0, w)
            return nudge(g, dx), w
        w0 = smw(A0, B0, g0, U0, cold)[1]
        out["smw_warm_ms"] = stage_ms("smw_solve warm (B=8)",
                                      chain(smw_warm, (g0, w0)), reps)

        def both(carry, warm_start=True):
            p, w = carry
            A, Bo, g, U, _ = assemble(p)
            dx, w = smw(A, Bo, g, U, w if warm_start else cold)
            return nudge(p, dx), w
        out["assemble_smw_cold_ms"] = stage_ms(
            "assemble+smw cold (B=8)",
            chain(lambda c: both(c, False), (poses0, cold)), reps)
        out["assemble_smw_warm_ms"] = stage_ms(
            "assemble+smw warm (B=8)", chain(both, (poses0, w0)), reps)

    Ad0 = _damped(A0, torch.sum(U0 * U0, -1), 1e-4)
    Ub = U0.to(torch.bfloat16)
    C = U0.shape[-1]

    def factors(Ad):
        return [bt_factor(a, b, ns_iters=8, direct_threshold=4)
                for a, b in zip(Ad, B0)]

    def factor_step(Ad):
        tails = torch.stack([f.tail_Hinv.sum() for f in factors(Ad)])
        return Ad + 1e-12 * tails[:, None, None, None]

    def apply_g(g):
        return torch.stack([bt_apply(f, -x[..., None])[..., 0]
                            for f, x in zip(factors(Ad0), g)])

    out["factor_ms"] = stage_ms("bt_factor (B=8)", chain(factor_step, Ad0),
                                reps)
    out["factor_apply_g_ms"] = stage_ms(
        "factor+apply g 1col (B=8)",
        chain(lambda g: nudge(g, apply_g(g)), g0), reps)
    out["factor_apply_U_ms"] = stage_ms(
        f"factor+apply U {C}col bf16",
        lambda: [bt_apply(f, u) for f, u in zip(factors(Ad0), Ub)], reps)
    YU = torch.stack([bt_apply(f, u) for f, u in zip(factors(Ad0), Ub)])
    YU = YU.float().reshape(B, -1, C)
    Uf = U0.reshape(B, -1, C)

    def apply_s(g):
        yb = apply_g(g)
        S = torch.eye(C, device=dev) + Uf.mT @ YU
        Uyb = (Uf.mT @ yb.reshape(B, -1, 1))[..., 0]
        z = torch.stack([spd_solve_approx(s, b) for s, b in zip(S, Uyb)])
        return nudge(g, yb.reshape(B, -1) - (YU @ z[..., None])[..., 0])
    out["factor_apply_S_ms"] = stage_ms("factor+applyg+S+cap+corr",
                                        chain(apply_s, g0), reps)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.profile_solver",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--internals-only", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    with torch.no_grad():
        out = profile(args.device, internals_only=args.internals_only)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
