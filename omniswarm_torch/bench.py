"""The port's benchmark: the rows of the root ``bench.py`` on the card.

    python -m omniswarm_torch.bench [--device cuda|cpu] [--baseline PATH]
        [--rows efficiency baseline kf1024 dense_loops d10 fleet frontend]

Prints ONE JSON line with every key of the reference's (``BENCH_r05.json``'s
``parsed``), each measured in this run, plus ``card`` (the device's name),
``kernel_launches`` (K1's and K2's launches in each row) and
``row_seconds`` (each row's host seconds, set-up included). Progress goes
to stderr. The rows, each at the reference's sizes and seeds
(``bench.py:131-512``):

- headline (always run; the others divide by it): per-problem LM
  iterations/s of ``lm_solve_bt`` on 5 drones x 100 keyframes (seed 0, 100
  iterations, ``function_tolerance=0``, median of 5 perturbed inits), and
  the batch of 8 inits (``benchutil.batch_inits``) through
  ``lm_solve_bt_batched`` (the port runs its lanes one after another, where
  the reference runs them in lock-step);
- efficiency: FLOPs and bytes of one warm LM iteration (assembly and
  ``_smw_solve_core`` at ``_auto_pack``, fused levels as ``lm_solve_bt``
  runs them) by ``benchutil.count_ops``, against the card's peaks
  (``benchutil.CARD_PEAKS``; another card leaves these fields out);
- baseline: the CPU baseline of ``omniswarm_torch.cpu_baseline``, measured
  on the card's own host (``--baseline``; absent, the ``vs_*`` fields are
  null; the pre-port ``BASELINE_MEASURED.json`` is another host's and is
  never read);
- kf1024: 5 x 1024 (seed 1, ``loop_every=128``, 25 iterations) and the same
  solve unfused, whose cost must lie within 2e-3 of the fused one;
- dense_loops: 5 x 1024 (seed 4, ``loop_every=2``: 2,555 loops, PCG by the
  ``"auto"`` rule, 25 iterations);
- d10: 10 drones x 100 (seed 3, 50 iterations);
- fleet: 8 problems (seeds 100-107) stacked with one loop capacity through
  ``parallel/swarm_batch.py`` (50 iterations; then to convergence);
- frontend: views/s of ``SuperPointExtractor`` + ``GlobalDescriptorExtractor``
  (the reference's architecture: a v1 encoder, 64 clusters, projection to
  4096, Flax's random init from a seeded generator) at 400 x 208, in bf16 at
  B = 4, 16 and 64 and in f32 at B = 4 (4 distinct batches cycled, 50 calls,
  median of 3), each under ``highp`` (no TF32: the f32 row runs true-f32
  cuDNN convolutions, as the production front-end does); per-view FLOPs
  by the counter; and the fused keyframe path, ``LoopCam.extract_stereo_batch``
  on 4 uint8 stereo pairs (the bundled checkpoints, f32).

Unlike the reference, which turns a failed row into a ``*_error`` key, a
failing row raises: no failure hides in the line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from omniswarm_torch import sim
from omniswarm_torch.benchutil import (BATCH, BUDGET_ANCHOR_ITER_PER_S, ITERS,
                                       batch_inits, card_peaks, count_ops,
                                       measured_solve, sim_problem, sync)
from omniswarm_torch.convert import dense_graph_to_torch
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.ops.frontend_kernels import grid_nms, grid_nms_ref
from omniswarm_torch.solver.dense import (_auto_pack, _smw_solve_core,
                                          assemble_blocks,
                                          dense_graph_from_sim, lm_solve_bt,
                                          lm_solve_bt_batched)
from omniswarm_torch.solver.fused_level import (fused_reduction_level,
                                                fused_reduction_level_ref)

ROWS = ("efficiency", "baseline", "kf1024", "dense_loops", "d10", "fleet",
        "frontend")
DEFAULT_BASELINE = "build/bench/baseline_cpu.json"
FUSED_COST_BAR = 2e-3        # bench.py:293-301
FLEET = 8


class Sizes(NamedTuple):
    """The rows' sizes; the defaults are the reference's."""

    frames: int = 100           # headline, batch of 8, d10, fleet lanes
    big_frames: int = 1024      # kf1024, dense loops
    iters: int = ITERS
    big_iters: int = 25
    d10_iters: int = 50
    fleet_iters: int = 50
    reps: int = 5               # perturbed inits timed, headline and batch
    big_reps: int = 3           # the other solver rows
    frontend_hw: Tuple[int, int] = (208, 400)
    frontend_batches: Tuple[int, int, int] = (4, 16, 64)
    fused_batch: int = 4        # stereo pairs a fused call
    frontend_calls: int = 50
    fused_calls: int = 20
    frontend_runs: int = 3
    warm_up: bool = True        # False: each solver row times its first solve


def prog(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench: {msg}")


def _solve_and_time(solve, init_np, reps: int, dev, warm_up: bool):
    """(``solve(init)``, seconds a solve): the median over ``reps``
    perturbed inits after that first solve, or with ``warm_up`` False the
    first solve's own time (one timed solve, nothing run before it)."""
    res, got = measured_solve(solve, init_np, dev, reps if warm_up else 0)
    return res, got["seconds"]


@highp()
def iteration_cost(graph, poses):
    """(FLOPs, bytes) of one warm LM iteration of ``lm_solve_bt``'s fast
    path: assembly, then ``_smw_solve_core`` at ``_auto_pack`` with the
    warm state of a cold solve, fused levels where it packs (the
    reference's ``iter_flops_for``, bench.py:184-203, counted unfused)."""
    F, D = poses.shape[:2]
    pk = _auto_pack(F, 4 * D)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=poses.device)
    A, B, g, U, _ = assemble_blocks(graph, poses)
    _, warm = _smw_solve_core(A, B, g, U.to(torch.bfloat16), lam, None,
                              pack=pk, fused_levels=pk > 1)

    def one_iteration():
        A, B, g, U, _ = assemble_blocks(graph, poses)
        return _smw_solve_core(A, B, g, U.to(torch.bfloat16), lam, warm,
                               pack=pk, fused_levels=pk > 1)[0]

    return count_ops(one_iteration)[:2]


def headline(s: Sizes, dev, ctx: dict) -> dict:
    _, graph, init, init_np = sim_problem(dev, num_drones=5,
                                          num_frames=s.frames, seed=0)
    kw = dict(device=dev, max_iterations=s.iters, function_tolerance=0.0)
    res, dt = _solve_and_time(lambda p: lm_solve_bt(graph, p, **kw),
                              init_np, s.reps, dev, s.warm_up)
    check(np.isfinite(float(res.cost)), "solver diverged")
    check(float(res.cost) < float(res.initial_cost), "no cost decrease")
    per_problem = res.iterations / dt

    inits_np = batch_inits(init_np)
    resb, dtb = _solve_and_time(
        lambda p: lm_solve_bt_batched(graph, p, **kw), inits_np, s.reps,
        dev, s.warm_up)
    check(bool(torch.isfinite(resb.cost).all()), "batched solver diverged")
    aggregate = resb.iterations * BATCH / dtb
    ctx.update(graph=graph, init=init, per_problem=per_problem,
               aggregate=aggregate)
    return {"value": round(per_problem, 2),
            "aggregate_iter_per_s_batch8": round(aggregate, 2),
            "vs_budget_anchor_aggregate":
                round(aggregate / BUDGET_ANCHOR_ITER_PER_S, 3)}


def efficiency(s: Sizes, dev, ctx: dict) -> dict:
    peaks = ctx["peaks"]
    out = {"chip_kind": ctx["card"]}
    if peaks is None:
        return out
    peak, hbm = peaks
    fl, by = iteration_cost(ctx["graph"], ctx["init"])
    rate = ctx["per_problem"]
    out.update(
        chip_peak_bf16_flops=peak, chip_peak_hbm_gbps=hbm / 1e9,
        solver_flops_per_iter=round(fl),
        solver_achieved_tflops=round(fl * rate / 1e12, 3),
        solver_mfu=round(fl * rate / peak, 5),
        solver_mfu_batch8=round(fl * ctx["aggregate"] / peak, 5),
        solver_bytes_per_iter=round(by),
        solver_hbm_gbps=round(by * rate / 1e9, 2),
        solver_hbm_frac=round(by * rate / hbm, 4),
        solver_op_intensity=round(fl / by, 2),
        chip_critical_intensity=round(peak / hbm, 1))
    return out


def baseline(path, ctx: dict) -> dict:
    """The ``vs_*`` fields against the CPU baseline's JSON at ``path``
    (null where the file is absent)."""
    cpu = json.loads(Path(path).read_text()) if Path(path).exists() else {}
    if not cpu:
        prog(f"no CPU baseline at {path}: the vs_* fields are null "
             f"(python -m omniswarm_torch.cpu_baseline writes it)")
    pp = float(cpu.get("best_cpu_iter_per_s", 0.0)) or None
    ag = float(cpu.get("best_cpu_aggregate_iter_per_s", 0.0)) or None
    per_problem, aggregate = ctx["per_problem"], ctx["aggregate"]
    return {
        "vs_baseline": round(per_problem / pp, 3) if pp else None,
        "vs_baseline_measured_per_problem":
            round(per_problem / pp, 3) if pp else None,
        "vs_baseline_measured_aggregate":
            round(aggregate / ag, 3) if ag else None,
        "cpu_baseline_per_problem_iter_per_s": pp,
        "cpu_baseline_aggregate_iter_per_s": ag,
        "cpu_baseline_host": f"{cpu.get('host', '?')}x{cpu.get('nproc', '?')}",
    }


def kf1024(s: Sizes, dev, ctx: dict) -> dict:
    F = s.big_frames
    _, graph, init, init_np = sim_problem(dev, num_drones=5, num_frames=F,
                                          seed=1, loop_every=128)
    kw = dict(device=dev, max_iterations=s.big_iters, function_tolerance=0.0)
    res, dt = _solve_and_time(lambda p: lm_solve_bt(graph, p, **kw),
                              init_np, s.big_reps, dev, s.warm_up)
    check(np.isfinite(float(res.cost)), "kf1024 diverged")
    it = res.iterations
    out = {"kf1024_iter_per_s": round(it / dt, 2),
           "kf1024_ms_per_iter": round(dt / it * 1e3, 3),
           "kf1024_pose_updates_per_s": round(it * F * 5 / dt, 0),
           # pose-update rate at F=1024 over the headline's (1.0: linear)
           "kf1024_linearity": round((it * F * 5 / dt) / max(
               ctx["per_problem"] * s.frames * 5, 1e-9), 3)}
    if ctx["peaks"] is not None:
        peak, hbm = ctx["peaks"]
        fl, by = iteration_cost(graph, init)
        rate = it / dt
        out.update(kf1024_achieved_tflops=round(fl * rate / 1e12, 3),
                   kf1024_mfu=round(fl * rate / peak, 5),
                   kf1024_bytes_per_iter=round(by),
                   kf1024_hbm_gbps=round(by * rate / 1e9, 2),
                   kf1024_hbm_frac=round(by * rate / hbm, 4),
                   kf1024_op_intensity=round(fl / by, 2))
    # the fused levels (K1) against the unfused solve of the same problem
    unfused = lm_solve_bt(graph, init, fused=False, **kw)
    cf, cnf = float(res.cost), float(unfused.cost)
    out["kf1024_fused_cost_delta"] = round(abs(cf - cnf)
                                           / max(abs(cnf), 1e-12), 8)
    check(abs(cf - cnf) <= FUSED_COST_BAR * max(abs(cnf), 1e-9),
          f"fused-level cost mismatch: fused={cf} unfused={cnf}")
    return out


def dense_loops(s: Sizes, dev, ctx: dict) -> dict:
    data, graph, _, init_np = sim_problem(dev, num_drones=5,
                                          num_frames=s.big_frames, seed=4,
                                          loop_every=2)
    kw = dict(device=dev, max_iterations=s.big_iters, function_tolerance=0.0)
    res, dt = _solve_and_time(lambda p: lm_solve_bt(graph, p, **kw),
                              init_np, s.big_reps, dev, s.warm_up)
    check(np.isfinite(float(res.cost)), "dense loops diverged")
    check(float(res.cost) < float(res.initial_cost),
          "dense loops: no cost decrease")
    return {"kf1024_dense_loops": len(data.loops),
            "kf1024_dense_loops_iter_per_s": round(res.iterations / dt, 2),
            "kf1024_dense_loops_ms_per_iter":
                round(dt / res.iterations * 1e3, 3)}


def d10(s: Sizes, dev, ctx: dict) -> dict:
    _, graph, _, init_np = sim_problem(dev, num_drones=10,
                                       num_frames=s.frames, seed=3)
    kw = dict(device=dev, max_iterations=s.d10_iters, function_tolerance=0.0)
    res, dt = _solve_and_time(lambda p: lm_solve_bt(graph, p, **kw),
                              init_np, s.big_reps, dev, s.warm_up)
    check(np.isfinite(float(res.cost)), "d10 diverged")
    return {"d10_iter_per_s": round(res.iterations / dt, 2)}


def fleet(s: Sizes, dev, ctx: dict) -> dict:
    from omniswarm_torch.parallel.swarm_batch import (lm_solve_multigraph,
                                                      stack_graphs)

    sims = [sim.generate(sim.SimParams(num_drones=5, num_frames=s.frames,
                                       seed=100 + k)) for k in range(FLEET)]
    # one loop capacity for the stack, kept tight (bench.py:369-371)
    cap = max(8, max(len(d.loops) for d in sims))
    graphs = [dense_graph_from_sim(d, max_loops=cap) for d in sims]
    poses_np = np.stack([np.asarray(d.vio, np.float32) for d in sims])
    t0 = time.perf_counter()
    stacked = dense_graph_to_torch(stack_graphs(graphs), dev)
    poses = torch.from_numpy(poses_np).to(dev)
    sync(poses)
    dt_prep = time.perf_counter() - t0

    def solve(tol, p):
        return lm_solve_multigraph(stacked, p, device=dev,
                                   max_iterations=s.fleet_iters,
                                   function_tolerance=tol)

    res, dt = _solve_and_time(lambda p: solve(0.0, p), poses_np,
                              s.big_reps, dev, s.warm_up)
    check(bool(torch.isfinite(res.cost).all()), "fleet diverged")
    conv, dt_c = _solve_and_time(lambda p: solve(1e-6, p), poses_np,
                                 s.big_reps, dev, s.warm_up)
    return {"fleet_aggregate_iter_per_s":
                round(res.iterations * FLEET / dt, 2),
            "fleet_prep_ms": round(dt_prep * 1e3, 1),
            "fleet_windows_per_s": round(FLEET / dt_c, 2),
            "fleet_converge_iters": conv.iterations}


NETVLAD_ARCH = dict(num_clusters=64, out_dim=4096, use_proj=True)


def random_weights(seed: int = 0):
    """State dicts of the reference bench's extractors (bench.py:423-426)
    with Flax's random init from ``seed``: SuperPoint with a N(0, 1)/16
    PCA, and MobileNetVLAD v1 with 64 clusters and a projection to 4096."""
    from omniswarm_torch.models.netvlad import init_mobilenetvlad
    from omniswarm_torch.models.superpoint import init_superpoint

    gen = torch.Generator().manual_seed(seed)
    sp = {f"net.{k}": v for k, v in init_superpoint(gen).state_dict().items()}
    sp["pca_components"] = torch.randn(64, 256, generator=gen) / 16.0
    sp["pca_mean"] = torch.zeros(256)
    nv = init_mobilenetvlad(gen, 1, **NETVLAD_ARCH).state_dict()
    return sp, {f"model.{k}": v for k, v in nv.items()}


def extractors(weights, dtype, dev):
    """(SuperPointExtractor with 200 keypoints, GlobalDescriptorExtractor)
    of ``random_weights``, their trunks in ``dtype``, on ``dev``."""
    from omniswarm_torch.models.netvlad import GlobalDescriptorExtractor
    from omniswarm_torch.models.superpoint import SuperPointExtractor

    sp = SuperPointExtractor(weights[0], max_keypoints=200, dtype=dtype)
    nv = GlobalDescriptorExtractor(weights[1], encoder_version=1,
                                   dtype=dtype, **NETVLAD_ARCH)
    return sp.to(dev).eval(), nv.to(dev).eval()


@highp()
def frontend(s: Sizes, dev, ctx: dict) -> dict:
    from omniswarm_torch.config import FrontendParams
    from omniswarm_torch.swarm.loop_cam import CameraIntrinsics, LoopCam

    H, W = s.frontend_hw
    rng0 = np.random.default_rng(0)
    weights = random_weights()

    def rate(dtype, B):
        """(views/s, FLOPs a view) of the two CNNs at batch B."""
        imgs = [torch.from_numpy(rng0.uniform(size=(B, H, W)).astype(
            np.float32))[:, None].to(dev) for _ in range(4)]
        sp, nv = extractors(weights, dtype, dev)
        sync((sp(imgs[0]), nv(imgs[0])))
        ts = []
        for _ in range(s.frontend_runs):
            t0 = time.perf_counter()
            for i in range(s.frontend_calls):
                o = (sp(imgs[i % 4]), nv(imgs[i % 4]))
            sync(o)
            ts.append(time.perf_counter() - t0)
        fl, _, _ = count_ops(lambda: (sp(imgs[0]), nv(imgs[0])))
        return B / (float(np.median(ts)) / s.frontend_calls), fl / B

    scan, fl_view = [], None
    for B in s.frontend_batches:
        prog(f"frontend B={B}")
        r, fl_view = rate(torch.bfloat16, B)
        scan.append(r)
    out = {"frontend_views_per_s": round(scan[0], 2),
           "frontend_views_per_s_b16": round(scan[1], 2),
           "frontend_views_per_s_b64": round(scan[2], 2),
           "frontend_dtype": "bfloat16"}
    prog("frontend f32")
    out["frontend_views_per_s_f32"] = round(
        rate(torch.float32, s.frontend_batches[0])[0], 2)
    prog("frontend fused")
    cam = LoopCam(params=FrontendParams(width=W, height=H),
                  intrinsics=CameraIntrinsics(fx=220, fy=220, cx=W / 2,
                                              cy=H / 2),
                  baseline=0.2, device=dev)
    B4 = s.fused_batch
    pairs = [(rng0.integers(0, 255, size=(B4, H, W)).astype(np.uint8),
              rng0.integers(0, 255, size=(B4, H, W)).astype(np.uint8))
             for _ in range(4)]
    cam.extract_stereo_batch(*pairs[0])
    ts = []
    for _ in range(s.frontend_runs):
        t0 = time.perf_counter()
        for i in range(s.fused_calls):
            cam.extract_stereo_batch(*pairs[i % 4])    # returns numpy
        ts.append(time.perf_counter() - t0)
    out["frontend_views_per_s_fused_b4"] = round(
        2 * B4 / (float(np.median(ts)) / s.fused_calls), 2)
    if ctx["peaks"] is not None:
        peak = ctx["peaks"][0]
        best = max(scan)
        out.update(frontend_flops_per_view=round(fl_view),
                   frontend_achieved_tflops_b64=round(fl_view * best / 1e12,
                                                      3),
                   frontend_mfu_b64=round(fl_view * best / peak, 5))
    return out


def run(device="cuda", baseline_path=DEFAULT_BASELINE, rows=ROWS,
        sizes: Sizes = Sizes()) -> dict:
    """The bench's JSON object (see the module docstring); the headline
    always runs, ``rows`` picks the others."""
    dev = resolve_device(device)
    unknown = set(rows) - set(ROWS)
    if unknown:
        raise ValueError(f"unknown rows {sorted(unknown)}; rows: {ROWS}")
    ctx = {"card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"), "peaks": card_peaks(dev)}
    launches, seconds = {}, {}

    def counted(name, fn):
        k1, k2 = fused_reduction_level.launches, grid_nms.launches
        plain = fused_reduction_level_ref.calls + grid_nms_ref.calls
        t0 = time.perf_counter()
        fields = fn()
        seconds[name] = round(time.perf_counter() - t0, 3)
        launches[name] = {"k1": fused_reduction_level.launches - k1,
                          "k2": grid_nms.launches - k2}
        if dev.type == "cuda":
            check(fused_reduction_level_ref.calls + grid_nms_ref.calls
                  == plain, f"a plain kernel version ran in row {name}")
        prog(f"{name} done, {seconds[name]:.1f} s")
        return fields

    prog("start")
    fields = counted("headline", lambda: headline(sizes, dev, ctx))
    steps = {"efficiency": lambda: efficiency(sizes, dev, ctx),
             "baseline": lambda: baseline(baseline_path, ctx),
             "kf1024": lambda: kf1024(sizes, dev, ctx),
             "dense_loops": lambda: dense_loops(sizes, dev, ctx),
             "d10": lambda: d10(sizes, dev, ctx),
             "fleet": lambda: fleet(sizes, dev, ctx),
             "frontend": lambda: frontend(sizes, dev, ctx)}
    for name in ROWS:
        if name in rows:
            fields.update(counted(name, steps[name]))
    return {"metric": "pose_graph_lm_iter_per_s_5drone_100kf_per_problem",
            "unit": "iter/s", **fields, "card": ctx["card"],
            "kernel_launches": launches, "row_seconds": seconds}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m omniswarm_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="the CPU baseline's JSON "
                         "(python -m omniswarm_torch.cpu_baseline)")
    ap.add_argument("--rows", nargs="+", choices=ROWS, default=list(ROWS),
                    help="rows besides the headline, which always runs")
    args = ap.parse_args(argv)
    out = run(args.device, args.baseline, args.rows)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
