#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. Every phase is fatal: any failure raises and the script exits
non-zero without printing a result.

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the port from csrc/ (one nvcc per source, started together).
2. K1 phase: the fused cyclic-reduction level kernel against its plain
   PyTorch version on the card (rtol = atol = 2e-4 on all 7 outputs) at
   every level shape the solves launch (m=40 with t=32, 16, 8, 4 at F=100;
   m=80 with t=128, 64, 32, 16, 8, 4 at F=1024) and at odd widths and single
   pairs, each on the warm, guard-fallback and NaN-start branches. Timed:
   the warm branch at every level shape, the fallback branch at (40, 32),
   (80, 128) and (80, 4) and the NaN start at (80, 4). Each timed row gives
   the CTAs per pair (cluster size), the kernel's CUDA-event median and the
   least time the card could take (bytes over 3.35 TB/s, FLOPs over
   67 TFLOP/s FP32); the warm and fallback rows at (40, 32) and (80, 128)
   also time the wrapper and the plain version.
3. Main path: omniswarm_torch.entry.entry() at F=100, D=5, seed 0,
   20 LM iterations. Checks a finite cost below the initial one, within 1%
   of the reference's 177.25, relative ATE < 0.08, 4 kernel launches per
   iteration at the level shapes above (recorded in the run); the same
   solve with fused=False must agree within 1e-3. Then K1's kernel ms per
   LM iteration: the K1 phase's time of each shape the run launched, times
   its launches, beside the summed bound.
4. The same at F=1024 (pack 4, m=80, 6 launches per iteration), against
   the reference's 2330.99 and relative ATE < 0.1.
5. K2 phase: the grid-NMS kernel against its plain version at
   (40, 208, 400), the shape of one front-end step, on random u**8 heat and
   on a real SuperPoint heat map of the path's first step: bit-exact.
   CUDA-event medians of the kernel, the plain version and the library
   call (max_pool2d + where), beside the bytes bound.
6. K3 phase: the top-1 retrieval kernel against its plain version at
   N = D = 4096 and at N = 512, D = 4096, Q = 1 and 5, and at the edge
   shapes N = 1000, D = 130, Q = 9 and N = D = 4096, Q = 8, on a partly
   masked DB with planted ties (across CTAs and inside one row tile) and
   an all-masked query: equal indices, the lower row of each tie,
   (0, -inf) for the masked query, similarities within 1e-5 relative. The
   same timings (library: argmax of the masked matmul).
7. Front-end path: omniswarm_torch.frontend_entry.frontend_entry() at
   full size (5 drones x 15 keyframe steps of 40 views at 400 x 208). No
   plain version may run; K2 and K3 launch 15 times each. Held against the
   JAX package's CPU anchors: each keyframe's landmark count, keypoint sums,
   inverse-range landmark sums and global-descriptor projection within
   frontend_entry.checksum_faults's tolerances, at least 95% of the 75
   top-1 indices equal, the top-1 precision within 0.02.
8. One JSON line with the kernels' numbers, then the result line.
"""
from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time

import numpy as np

K1_FULL_ROWS = ((40, 32, "warm"), (40, 32, "fallback"), (80, 128, "warm"),
                (80, 128, "fallback"))
K1_EXTRA_ROWS = ((80, 4, "fallback"), (80, 4, "nan"))
K1_BRANCHES = ("warm", "fallback", "nan")
# (m, t) checked but not timed: widths other than 40 and 80 (the run-time-m
# instantiation, ragged and empty panels) and one pair at the extremes
K1_ODD_SHAPES = ((12, 2), (48, 8), (60, 3), (7, 5), (1, 1), (40, 1), (80, 1))
MAIN_PATHS = (
    # F, launches per LM iteration, reference cost, relative-ATE bar
    (100, 4, 177.25, 0.08),
    (1024, 6, 2330.99, 0.1),
)
K3_RTOL = 1e-5
K3_SHAPES = (
    # N, D, Q: the path's query_batch (5) and query (1) on the configured
    # 4096-slot DB and on the demo's 512; then edge shapes of the tiling:
    # ragged N and 4-byte loads (D % 4 != 0) over two query groups of 8,
    # and one full group of 8
    (4096, 4096, 5), (4096, 4096, 1), (512, 4096, 5), (512, 4096, 1),
    (1000, 130, 9), (4096, 4096, 8),
)
# The front-end path's anchors, from the JAX package on the CPU
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_frontend_entry.py
# --anchors): per-keyframe checksums (frontend_entry.keyframe_checksums),
# each keyframe's top-1 DB slot and the top-1 precision.
FE_ANCHORS = dict(
    top1_precision=0.6571428571428571, confident_queries=70,
    top1_idx=(0, 0, 0, 0, 0, 1, 2, 4, 4, 3, 4, 7, 9, 1, 8, 14, 10, 10, 2, 1,
              19, 8, 0, 7, 17, 1, 1, 18, 10, 17, 21, 6, 10, 16, 28, 2, 11, 7,
              31, 9, 15, 16, 4, 18, 21, 20, 21, 17, 3, 1, 25, 1, 29, 8, 24, 39,
              31, 22, 13, 17, 35, 11, 32, 19, 28, 63, 41, 2, 23, 37, 38, 46, 7,
              28, 21),
    landmarks=(524, 576, 500, 522, 598, 548, 534, 546, 603, 543, 558, 540, 560,
               506, 516, 538, 603, 506, 542, 541, 528, 534, 497, 522, 520, 533,
               570, 506, 520, 504, 571, 539, 502, 562, 561, 487, 547, 515, 509,
               550, 527, 607, 620, 519, 532, 517, 537, 537, 513, 525, 559, 564,
               510, 630, 515, 587, 506, 487, 527, 504, 480, 536, 525, 500, 530,
               488, 587, 516, 518, 595, 503, 555, 531, 536, 511),
    kp_sum=((160916.805, 85869.974), (156491.055, 85365.028), (162289.282,
            82006.374), (162973.769, 80791.986), (163221.379, 85462.234),
            (160891.477, 85136.979), (157868.728, 82375.176), (160719.157,
            84880.808), (163022.727, 85494.056), (158863.191, 83997.575),
            (162534.135, 84175.239), (165126.433, 82117.502), (150486.521,
            86668.116), (165467.519, 83985.569), (162013.403, 84679.301),
            (165320.682, 83746.027), (164381.088, 85316.937), (160722.554,
            84639.06), (152964.556, 88786.613), (173135.532, 81479.294),
            (159798.371, 86688.543), (155512.303, 85938.421), (152432.901,
            82862.994), (151610.218, 82031.466), (151138.456, 85430.067),
            (148357.519, 85859.21), (154599.151, 84694.762), (157641.523,
            84003.414), (160519.44, 84801.853), (162481.607, 82295.868),
            (157055.642, 86133.624), (154803.016, 83881.831), (161678.784,
            85618.166), (153058.367, 81922.646), (167839.341, 84700.574),
            (159510.895, 84964.669), (159717.057, 86106.21), (162941.578,
            83574.195), (159787.189, 84684.232), (157804.762, 84279.368),
            (171182.196, 84844.46), (162383.645, 86866.161), (171386.972,
            86176.287), (163978.37, 82698.842), (158427.401, 85375.581),
            (167818.613, 83067.376), (155229.371, 86419.635), (153933.391,
            82919.328), (170865.173, 82205.939), (166280.081, 81043.688),
            (156044.201, 88715.672), (156542.713, 84216.741), (159349.296,
            83008.922), (161247.13, 84492.409), (152222.002, 88843.594),
            (153049.145, 85712.899), (154671.6, 82902.267), (153064.799,
            79733.444), (165738.74, 84181.242), (161629.81, 83676.586),
            (166038.896, 85967.644), (156560.384, 81954.836), (149838.312,
            86178.574), (151025.371, 87997.849), (161495.447, 84201.801),
            (158636.143, 83028.792), (164821.869, 86442.637), (160160.86,
            85782.31), (157230.5, 81037.26), (151303.381, 87321.526),
            (162375.601, 86696.139), (160777.104, 86874.854), (163467.121,
            83386.581), (159329.435, 84616.688), (152042.12, 87121.18)),
    lm_inv_sum=((-7.36609, -39.189797, -1.366037), (-9.719004, -21.015196,
                -1.814145), (-20.2897, -5.890532, 0.049774), (11.262751,
                -33.365528, 2.568859), (-4.361177, -1.745694, -1.645403),
                (-6.06289, -6.022681, -0.673011), (12.474881, -22.925876,
                1.051842), (-4.345803, 0.374254, -0.4472), (5.378601,
                -3.331657, -1.07321), (4.677006, 2.789286, 0.63838), (3.928428,
                -7.869058, -1.255116), (2.335169, -9.132136, 0.064887),
                (0.262768, 3.765505, -3.2712), (-10.964209, -9.866562,
                -2.142258), (19.342016, -11.527234, 0.065713), (20.031369,
                -48.373501, 0.337258), (-4.039806, 1.071637, -2.338996),
                (13.885994, -10.59523, -1.663062), (-14.579124, -70.535097,
                -6.309358), (8.784424, -69.448569, 6.72844), (-1.577814,
                -38.420304, -4.73328), (-4.67203, -10.397353, -2.319686),
                (21.956062, -31.937385, -1.95546), (21.687299, -37.531671,
                -0.34116), (-16.42133, -31.129523, -2.041613), (-22.53704,
                -30.932113, -3.21845), (-10.287503, -28.070887, -0.336958),
                (-8.170849, -99.532453, 1.340757), (9.013678, -10.372566,
                -0.268964), (-16.138765, -10.397598, 1.873984), (-5.066998,
                -4.576527, -1.608008), (12.25149, -11.888988, -0.041071),
                (-38.382023, -20.42112, -2.523903), (-2.40014, -5.059318,
                0.037488), (-8.238118, -3.058496, -1.13157), (10.427749,
                -10.362117, -1.415896), (2.51258, -12.617554, -0.813411),
                (-9.297553, 1.208446, -0.64218), (-17.375889, -16.431051,
                -0.697534), (1.849139, 4.06629, 0.070629), (10.717195,
                -45.69463, 0.144126), (-2.142912, 0.057579, -2.043874),
                (-2.303629, 1.064362, -1.597571), (-5.584202, -84.26584,
                2.678902), (17.083203, -5.71703, -1.235202), (2.096681,
                -37.456343, 3.267637), (-3.871743, -7.657265, -1.070165),
                (13.852808, -5.644939, 0.689138), (7.466599, -33.472123,
                -0.170364), (16.37212, -36.300987, 1.171881), (-22.080863,
                -21.652346, -3.628631), (-12.584474, -31.244329, -1.752744),
                (21.879221, -16.048803, -0.004565), (5.574414, -4.318343,
                -0.246581), (-11.751028, -58.52051, -4.956961), (0.449088,
                -1.45384, -1.388851), (8.784457, -15.429235, -0.377291),
                (-0.033211, -86.771255, 9.019339), (-12.095803, -0.029931,
                -0.416161), (-4.036973, -24.097314, -0.978943), (8.233795,
                -5.289856, -1.026386), (6.362237, -2.909847, 0.23097),
                (-11.083176, -73.433614, -2.484478), (-17.307413, -59.013999,
                -0.950253), (-8.814789, -2.458863, -0.437269), (1.859964,
                -55.479658, 4.203903), (-2.438727, -1.134331, -2.031488),
                (-23.930251, -9.420233, 1.04143), (19.186559, -38.115148,
                5.006448), (-0.549273, 0.000211, -2.545973), (-11.283319,
                -40.012582, -1.34599), (-2.420054, -6.24206, -1.22362),
                (-9.641346, 2.150888, 0.043214), (9.662992, -12.130339,
                -0.30369), (14.895574, -2.404426, -0.760134)),
    gd_proj=(0.0002359, 0.0026159, 0.004165, 0.0028503, 0.0043977, -0.0013087,
             0.0078515, 0.0039374, 0.0031859, 0.0012536, 0.0042095, 0.0033734,
             0.0034153, 0.0014229, 0.0046766, 0.0002476, 0.0028707, 0.0036155,
             0.0034142, 0.0076464, 0.004393, 0.000484, 0.0049237, 0.0019787,
             0.0043858, 0.0025216, 0.0024261, 0.0045715, 0.0021392, 0.0036183,
             0.001206, 0.005434, 0.0027973, 0.0037596, 0.0027009, 0.0049578,
             0.0020064, 0.0018974, 0.0040737, 0.0034115, 0.0005519, 0.0030287,
             0.0047343, 0.0051351, 0.0018449, 0.005725, 0.0004991, 0.005171,
             0.00256, 0.0052548, 0.00238, 0.0024843, 0.0019004, 0.0003091,
             0.0059957, 0.0037934, 0.0043418, 0.0072818, 0.0027544, 0.0017053,
             0.0046733, 0.0023425, 0.0022247, 0.0067866, 0.0034184, 0.0059519,
             0.004699, 0.0028713, 0.0028951, 0.00221, 0.0028499, -0.0001949,
             0.0038631, 0.0016111, -6.7e-05),
)
FE_IDX_SHARE = 0.95         # top-1 indices equal to the anchors
FE_PRECISION_ATOL = 0.02
FE_STEPS = 15


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def kernel_phase():
    import torch

    from omniswarm_torch import kernels
    from omniswarm_torch.benchutil import (SOLVE_LEVELS, check_level,
                                           level_bound_ms, random_level,
                                           time_ms)
    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    rng = np.random.default_rng(0)
    shapes = [(m, t) for _, m, ts in SOLVE_LEVELS for t in ts]
    timed = [(m, t, "warm") for m, t in shapes] + [
        r for r in K1_FULL_ROWS + K1_EXTRA_ROWS if r[2] != "warm"]
    rows, odd = [], []
    with highp():
        for m, t in shapes + list(K1_ODD_SHAPES):
            for branch in K1_BRANCHES:
                A, B, X0 = (torch.from_numpy(v).cuda()
                            for v in random_level(rng, 2 * t, m, branch))
                err = check_level(A, B, X0)
                cluster = kernels.fused_level_cluster(m, t)
                if (m, t, branch) not in timed:
                    odd.append(dict(m=m, t=t, branch=branch, cluster=cluster,
                                    max_abs_err=err))
                    continue
                bound_ms, by = level_bound_ms(m, t)
                row = dict(m=m, t=t, branch=branch, cluster=cluster,
                           max_abs_err=err,
                           ms=time_ms(
                               lambda: kernels.fused_level(A, B, X0, 0.95)),
                           bound_ms=bound_ms, bound_by=by)
                if (m, t, branch) in K1_FULL_ROWS:
                    row.update(
                        wrapper_ms=time_ms(
                            lambda: fused_reduction_level(A, B, X0)),
                        plain_ms=time_ms(
                            lambda: fused_reduction_level_ref(A, B, X0)))
                print("kernel fused_reduction_level", json.dumps(row),
                      flush=True)
                rows.append(row)
    print("K1 checked only", json.dumps(odd), flush=True)
    return rows, odd


def k1_per_iteration_of(rows, path):
    """K1's kernel ms and bound per LM iteration of a main path: the kernel
    phase's warm-branch time and bound of each level shape the path
    launched, as often as it launched it, over its iterations."""
    by_shape = {(r["m"], r["t"]): r for r in rows if r["branch"] == "warm"}
    n = path["iterations"]
    out = dict(launches=path["launches"] / n, ms=0.0, bound_ms=0.0)
    for m, t, count in path["levels"]:
        check((m, t) in by_shape, f"the path launched K1 at m={m} t={t}, "
              f"a shape the kernel phase did not time")
        out["ms"] += count * by_shape[m, t]["ms"] / n
        out["bound_ms"] += count * by_shape[m, t]["bound_ms"] / n
    print(f"K1 per LM iteration F={path['F']}: {out['launches']:g} launches "
          f"{out['ms']:.5f} ms (bound {out['bound_ms']:.5f} ms)", flush=True)
    return out


def main_path_phase(F: int, per_iter: int, ref_cost: float, ate_bar: float):
    import torch

    from omniswarm_torch import kernels
    from omniswarm_torch.benchutil import SOLVE_LEVELS
    from omniswarm_torch.entry import entry
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    iters = 20
    # record the (m, t) of every K1 launch of the solve (the wrapper counts)
    launch, levels = kernels.fused_level, collections.Counter()

    def recording_launch(A, B, X0, guard):
        levels[A.shape[-1], A.shape[0] // 2] += 1
        return launch(A, B, X0, guard)

    kernels.fused_level = recording_launch
    fused_reduction_level.launches = 0
    fused_reduction_level_ref.calls = 0
    try:
        res = entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                    max_iterations=iters)
    finally:
        kernels.fused_level = launch
    launches = fused_reduction_level.launches
    check(fused_reduction_level_ref.calls == 0,
          "the plain level ran on the card path")
    want = {(m, t): iters for F_, m, ts in SOLVE_LEVELS if F_ == F
            for t in ts}
    check(dict(levels) == want, f"K1 level shapes {dict(levels)}, "
          f"expected {want}")
    print(f"main path F={F} D=5: loops {res.num_loops} detections "
          f"{res.num_detections} cost {res.initial_cost:.4f} -> "
          f"{res.cost:.4f} (reference {ref_cost}) iterations "
          f"{res.iterations} rel ATE {res.relative_ate:.5f} (VIO "
          f"{res.vio_relative_ate:.5f}) K1 launches {launches} solve "
          f"{res.solve_s * 1e3:.1f} ms = "
          f"{res.solve_s * 1e3 / res.iterations:.2f} ms/iteration",
          flush=True)
    check(res.poses.shape == (F, 5, 4), f"poses shape {res.poses.shape}")
    check(bool(torch.isfinite(torch.as_tensor(res.poses)).all()),
          "poses not finite")
    check(math.isfinite(res.cost) and res.cost < res.initial_cost,
          f"cost {res.cost} not below initial {res.initial_cost}")
    check(abs(res.cost - ref_cost) <= 0.01 * ref_cost,
          f"cost {res.cost} not within 1% of {ref_cost}")
    check(res.relative_ate < ate_bar,
          f"relative ATE {res.relative_ate} >= {ate_bar}")
    check(res.iterations == iters, f"{res.iterations} iterations run")
    check(launches == per_iter * res.iterations,
          f"{launches} K1 launches, expected {per_iter * res.iterations}")

    unfused = entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                    max_iterations=iters, fused=False)
    rel = abs(unfused.cost - res.cost) / abs(unfused.cost)
    print(f"main path F={F} fused=False: cost {unfused.cost:.4f} rel delta "
          f"{rel:.3e} solve {unfused.solve_s * 1e3 / unfused.iterations:.2f}"
          f" ms/iteration", flush=True)
    check(unfused.k1_launches == 0, "fused=False launched the kernel")
    check(rel <= 1e-3, f"fused and unfused costs differ by {rel:.3e}")
    return dict(F=F, cost=res.cost, initial_cost=res.initial_cost,
                iterations=res.iterations, relative_ate=res.relative_ate,
                launches=launches,
                levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
                ms_per_iteration=res.solve_s * 1e3 / res.iterations,
                unfused_cost=unfused.cost,
                unfused_ms_per_iteration=(unfused.solve_s * 1e3
                                          / unfused.iterations))


def first_step_heat():
    """SuperPoint heat maps (40, 208, 400) of the front-end path's first
    keyframe step, on the card."""
    import torch

    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.frontend_entry import prepare
    from omniswarm_torch.models.superpoint import pretrained_extractor

    prep = prepare(kf_every=30)                 # renders step 0 only
    views = [im for e in prep.steps[0] for pair in e[4] for im in pair]
    imgs = torch.from_numpy(np.stack(views)).cuda()[:, None]
    ext = pretrained_extractor("cuda")
    with highp(), torch.no_grad():
        heat, _ = ext.net(imgs.float() * (1.0 / 255.0))
    return heat.contiguous()


def k2_phase():
    import torch
    import torch.nn.functional as F

    from omniswarm_torch import kernels
    from omniswarm_torch.benchutil import bound, time_ms
    from omniswarm_torch.ops.frontend_kernels import grid_nms_ref

    r = 4
    rng = np.random.default_rng(1)
    shape = (40, 208, 400)
    inputs = {
        "random_u8": torch.from_numpy(
            (rng.uniform(size=shape) ** 8).astype(np.float32)).cuda(),
        "superpoint_heat": first_step_heat(),
    }
    rows = []
    for name, heat in inputs.items():
        check(tuple(heat.shape) == shape, f"K2 input {name} {heat.shape}")
        got = kernels.grid_nms(heat, r)
        ref = grid_nms_ref(heat, r)
        torch.cuda.synchronize()
        check(torch.equal(got, ref),
              f"K2 disagrees on {name}: {int((got != ref).sum())} cells")
        kept = int((got > 0).sum())
        b_ms, by = bound(2 * heat.numel() * 4, heat.numel() * (4 * r + 1))
        row = dict(
            input=name, shape=list(shape), kept=kept, max_abs_err=float(
                (got - ref).abs().max()),
            ms=time_ms(lambda: kernels.grid_nms(heat, r)),
            plain_ms=time_ms(lambda: grid_nms_ref(heat, r)),
            library_ms=time_ms(lambda: torch.where(
                heat >= F.max_pool2d(heat[:, None], 2 * r + 1, 1, r)[:, 0],
                heat, 0.0)),
            bound_ms=b_ms, bound_by=by)
        print("kernel grid_nms", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def k3_inputs(rng, N: int, D: int, Q: int):
    """Unit DB rows, noisy queries of random rows, a mask with ~30% of the
    entries off and, for Q > 1, an all-masked last query. Planted ties
    (equal rows, a query on them; the lower row must win), as
    (query, winning row) pairs: rows N//2 and N-1 (query 0); for Q >= 4
    also rows 3 and 4, which K3 gives to different CTAs (4-row tiles 0 and
    1), and rows 8 and 9, inside one tile (queries 1 and 2)."""
    db = rng.normal(size=(N, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    pairs = [(N // 2, N - 1)] + ([(3, 4), (8, 9)] if Q >= 4 else [])
    for a, b in pairs:
        db[b] = db[a]
    q = db[rng.integers(0, N, size=Q)] + rng.normal(0, 0.05, size=(Q, D))
    for j, (a, _) in enumerate(pairs):
        q[j] = db[a]
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    mask = rng.uniform(size=(Q, N)) > 0.3
    mask[:, [row for pair in pairs for row in pair]] = True
    if Q > 1:
        mask[-1] = False
    return db, q, mask, [(j, a) for j, (a, _) in enumerate(pairs)]


def k3_phase():
    import torch

    from omniswarm_torch import kernels
    from omniswarm_torch.benchutil import bound, time_ms
    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.ops.frontend_kernels import retrieval_top1_ref

    rng = np.random.default_rng(2)
    rows = []
    with highp():
        for N, D, Q in K3_SHAPES:
            *arrays, ties = k3_inputs(rng, N, D, Q)
            db, q, mask = (torch.from_numpy(v).cuda() for v in arrays)
            idx, sim = kernels.retrieval_top1(db, q, mask)
            ridx, rsim = retrieval_top1_ref(db, q, mask)
            torch.cuda.synchronize()
            check(torch.equal(idx, ridx),
                  f"K3 indices differ at N={N} D={D} Q={Q}: "
                  f"{idx.tolist()} vs {ridx.tolist()}")
            for j, want in ties:
                check(int(idx[j]) == want,
                      f"K3 tie of query {j} broke to {int(idx[j])}, not "
                      f"{want}, at N={N} D={D} Q={Q}")
            fin = torch.isfinite(rsim)
            check(torch.equal(fin, torch.isfinite(sim)),
                  f"K3 masking differs at N={N} Q={Q}")
            rel = float(((sim[fin] - rsim[fin]).abs()
                         / rsim[fin].abs()).max())
            check(rel <= K3_RTOL, f"K3 similarity rel err {rel:.2e}")
            if Q > 1:
                check(int(idx[-1]) == 0 and bool(torch.isneginf(sim[-1])),
                      "K3 all-masked query is not (0, -inf)")
            b_ms, by = bound(N * D * 4 + Q * D * 4 + Q * N + Q * 12,
                             2.0 * Q * N * D)
            neg = torch.tensor(float("-inf"), device="cuda")
            row = dict(
                N=N, D=D, Q=Q, max_abs_err=float(
                    (sim[fin] - rsim[fin]).abs().max()), max_rel_err=rel,
                ms=time_ms(lambda: kernels.retrieval_top1(db, q, mask)),
                plain_ms=time_ms(lambda: retrieval_top1_ref(db, q, mask)),
                library_ms=time_ms(lambda: torch.argmax(
                    torch.where(mask, q @ db.T, neg), dim=1)),
                bound_ms=b_ms, bound_by=by)
            print("kernel retrieval_top1", json.dumps(row), flush=True)
            rows.append(row)
    return rows


def frontend_phase():
    from omniswarm_torch.frontend_entry import (
        checksum_faults, frontend_entry, keyframe_checksums, summary)
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1, retrieval_top1_ref)

    grid_nms.launches = retrieval_top1.launches = 0
    grid_nms_ref.calls = retrieval_top1_ref.calls = 0
    res = frontend_entry(device="cuda")
    k2, k3 = grid_nms.launches, retrieval_top1.launches
    out = summary(res)
    same = int((res.top1_idx == np.asarray(FE_ANCHORS["top1_idx"])).sum())
    faults, diffs = checksum_faults(keyframe_checksums(res.keyframes),
                                    FE_ANCHORS, 400, 208)
    out.update(k2_launches=k2, k3_launches=k3, top1_idx_equal=same,
               anchor_diffs=diffs,
               step_ms=[round(float(v), 3) for v in res.step_ms])
    print("frontend path", json.dumps(out), flush=True)
    check(grid_nms_ref.calls == 0 and retrieval_top1_ref.calls == 0,
          "a plain front-end kernel version ran on the card path")
    check(k2 == FE_STEPS and k3 == FE_STEPS,
          f"K2/K3 launched {k2}/{k3} times, expected {FE_STEPS} each")
    check(len(res.keyframes) == 5 * FE_STEPS,
          f"{len(res.keyframes)} keyframes")
    for kf in res.keyframes:
        check(kf.kp_xy.shape == (800, 2) and kf.landmarks_3d.shape
              == (800, 3) and kf.global_desc.shape == (4096,),
              "keyframe shapes")
        check(bool(np.isfinite(kf.landmarks_3d).all()
                   and np.isfinite(kf.global_desc).all()),
              "keyframe values not finite")
    check(not faults, "front-end disagrees with the anchors: "
          + "; ".join(faults))
    check(same >= FE_IDX_SHARE * len(res.top1_idx),
          f"only {same}/{len(res.top1_idx)} top-1 indices match")
    check(abs(res.precision - FE_ANCHORS["top1_precision"])
          <= FE_PRECISION_ATOL,
          f"top-1 precision {res.precision} vs "
          f"{FE_ANCHORS['top1_precision']}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from omniswarm_torch import kernels
    except ImportError:
        print("chip_smoke: run from the repository root (omniswarm_torch "
              "not found)", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    build_s = kernels.build()
    print(f"kernel build {build_s:.2f} s", flush=True)
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    rows, k1_checked = kernel_phase()
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", flush=True)

    # warm-up: library handles and allocator, outside the counted run
    from omniswarm_torch.entry import entry
    entry(device="cuda", max_iterations=2)

    paths, k1_per_iteration = {}, {}
    for F, per_iter, ref_cost, ate_bar in MAIN_PATHS:
        t0 = time.perf_counter()
        paths[F] = main_path_phase(F, per_iter, ref_cost, ate_bar)
        k1_per_iteration[F] = k1_per_iteration_of(rows, paths[F])
        print(f"main path F={F} phase {time.perf_counter() - t0:.1f} s",
              flush=True)

    t0 = time.perf_counter()
    k2_rows = k2_phase()
    k3_rows = k3_phase()
    print(f"K2/K3 phases {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fe = frontend_phase()
    print(f"front-end path phase {time.perf_counter() - t0:.1f} s",
          flush=True)

    main = next(r for r in rows
                if (r["m"], r["t"], r["branch"]) == (40, 32, "warm"))
    k2_main = next(r for r in k2_rows if r["input"] == "superpoint_heat")
    k3_main = next(r for r in k3_rows if (r["N"], r["Q"]) == (4096, 5))
    kernels_line = {"kernels": [{
        "name": "fused_reduction_level",
        "route": "cuda",
        "source": "omniswarm_torch/csrc/fused_level.cu",
        "replaces": "omniswarm_tpu/solver/pallas_level.py:89 "
                    "fused_reduction_level",
        "launches": paths[100]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + k1_checked),
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "wrapper_ms": main["wrapper_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "launches_f1024": paths[1024]["launches"],
        "shapes": rows,
        "checked": k1_checked,
        "per_iteration": k1_per_iteration,
        "main_paths": list(paths.values()),
    }, {
        "name": "grid_nms",
        "route": "cuda",
        "source": "omniswarm_torch/csrc/grid_nms.cu",
        "replaces": "omniswarm_tpu/ops/pallas_kernels.py:73 grid_nms_pallas",
        "launches": fe["k2_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "shapes": k2_rows,
    }, {
        "name": "retrieval_top1",
        "route": "cuda",
        "source": "omniswarm_torch/csrc/retrieval_top1.cu",
        "replaces": "omniswarm_tpu/ops/pallas_kernels.py:113 "
                    "retrieval_top1_pallas",
        "launches": fe["k3_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
        "ms": k3_main["ms"],
        "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"],
        "bound_by": k3_main["bound_by"],
        "library_ms": k3_main["library_ms"],
        "shapes": k3_rows,
        "frontend_path": fe,
    }]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
