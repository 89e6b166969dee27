"""Time the port's kernels at the shapes of PERF.md's kernel table.

    python -m omniswarm_torch.bench_kernels [--kernels K1 K2 K3 E1 C1]

Needs a CUDA card. Prints the card (name and power limit), then one JSON
line per row: the kernel's CUDA-event median (``ms``, ``benchutil.time_ms``:
inputs warm in L2), its plain version's (``plain_ms``), the library call
that does the same job where one exists (``library_ms``), and the least
time the card could take (``bound_ms``: bytes over 3.35 TB/s or FP32
operations over 67 TFLOP/s, the larger, named by ``bound_by``). It checks
no result: the ``cuda`` tests hold each kernel against its plain version
(tests/test_torch_kernels_card.py, test_torch_conv_epilogue.py,
test_torch_conv3x3.py, test_torch_rgbd.py).

- K1 (csrc/fused_level.cu) at each level shape the solves launch
  (``benchutil.SOLVE_LEVELS``), warm branch, also through its dispatcher
  (``wrapper_ms``); then its ms and bound per LM iteration of each
  drones x frames (one launch a level).
- K2 (csrc/grid_nms.cu), r = 4, at the keyframe steps of 5 and 10 drones
  (40 and 80 views of 208 x 400) and of the RGB-D cell (5 of 480 x 640);
  also cold (``cold_ms``: copies over 3x the 50 MB L2 in all, each call
  reading device memory). Library: max_pool2d and where.
- K3 (csrc/retrieval_top1.cu) on the PlaceDB's 4,096 x 4,096 rows and the
  demo's 512, Q = 5 and 1, about 30% of the rows masked. Library: argmax of
  the masked matmul.
- E1 (csrc/conv_epilogue.cu) at SuperPoint's four distinct epilogue cases
  at 80 views of 208 x 400. Library: the three ops of cuDNN's route (the
  in-place bias add, F.relu, F.max_pool2d).
- C1 (csrc/conv3x3.cu) at the distinct shapes of SuperPoint's nine 3 x 3
  convolutions at 5 views of 480 x 640 and 80 of 208 x 400. Plain:
  F.conv2d (cuDNN's heuristic); library: cuDNN's best f32 algorithm
  (``cudnn.benchmark``, set only around that timing).

K1, K3 and C1 run under ``highp`` (TF32 off), as the port's paths do.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from omniswarm_torch import kernels
from omniswarm_torch.benchutil import (SOLVE_LEVELS, bound, card,
                                       level_bound_ms, random_level,
                                       time_cold_ms, time_ms)
from omniswarm_torch.core.precision import highp
from omniswarm_torch.ops.frontend_kernels import (conv3x3_ref,
                                                  conv3x3_weight,
                                                  conv_epilogue_ref,
                                                  grid_nms_ref,
                                                  retrieval_top1_ref)
from omniswarm_torch.solver.fused_level import (fused_reduction_level,
                                                fused_reduction_level_ref)

NMS_RADIUS = 4
K2_SHAPES = ((40, 208, 400), (80, 208, 400), (5, 480, 640))
K3_SHAPES = ((4096, 4096, 5), (4096, 4096, 1), (512, 4096, 5),
             (512, 4096, 1))
# (conv output shape, relu, pool): conv1a, conv1b, conv3b, convPb
E1_CASES = (((80, 64, 208, 400), True, False),
            ((80, 64, 208, 400), True, True),
            ((80, 128, 52, 100), True, True),
            ((80, 65, 26, 50), False, False))
# (N, C, K, H, W): conv1b, conv2a (= conv2b), conv3a, conv3b, conv4a
# (= conv4b), convPa (= convDa)
C1_CASES = tuple((N, C, K, H >> d, W >> d)
                 for N, H, W in ((5, 480, 640), (80, 208, 400))
                 for C, K, d in ((64, 64, 0), (64, 64, 1), (64, 128, 2),
                                 (128, 128, 2), (128, 128, 3),
                                 (128, 256, 3)))
FEW = dict(reps=5, calls=10, warmup=2)      # E1: ms-long calls
FEWER = dict(reps=3, calls=2, warmup=1)     # C1: up to 12 ms a call


def emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def bench_k1() -> None:
    rng = np.random.default_rng(0)
    rows = {}
    with highp():
        for m, t in dict.fromkeys((m, t) for _, _, m, ts in SOLVE_LEVELS
                                  for t in ts):
            A, B, X0 = (torch.from_numpy(v).cuda()
                        for v in random_level(rng, 2 * t, m, "warm"))
            b_ms, by = level_bound_ms(m, t)
            rows[m, t] = emit(dict(
                kernel="K1", shape=[m, t],
                cluster=kernels.fused_level_cluster(m, t),
                ms=time_ms(lambda: kernels.fused_level(A, B, X0, 0.95)),
                wrapper_ms=time_ms(lambda: fused_reduction_level(A, B, X0)),
                plain_ms=time_ms(
                    lambda: fused_reduction_level_ref(A, B, X0)),
                library_ms=None, bound_ms=b_ms, bound_by=by))
    for F_, D, m, ts in SOLVE_LEVELS:
        emit(dict(kernel="K1", per_iteration=f"{D}x{F_}", m=m,
                  launches=len(ts),
                  ms=sum(rows[m, t]["ms"] for t in ts),
                  plain_ms=sum(rows[m, t]["plain_ms"] for t in ts),
                  bound_ms=sum(rows[m, t]["bound_ms"] for t in ts)))


def bench_k2() -> None:
    rng, r = np.random.default_rng(1), NMS_RADIUS
    for shape in K2_SHAPES:
        heat = torch.from_numpy((rng.uniform(size=shape) ** 8).astype(
            np.float32)).cuda()
        n = heat.numel()
        cold = [heat.clone()
                for _ in range(max(10, math.ceil(150e6 / (4 * n))))]
        b_ms, by = bound(2 * 4 * n, n * (4 * r + 1))
        emit(dict(
            kernel="K2", shape=list(shape), r=r,
            ms=time_ms(lambda: kernels.grid_nms(heat, r)),
            cold_ms=time_cold_ms(lambda h: kernels.grid_nms(h, r), cold),
            plain_ms=time_ms(lambda: grid_nms_ref(heat, r)),
            library_ms=time_ms(lambda: torch.where(
                heat >= F.max_pool2d(heat[:, None], 2 * r + 1, 1, r)[:, 0],
                heat, 0.0)),
            bound_ms=b_ms, bound_by=by))
        del cold


def bench_k3() -> None:
    rng = np.random.default_rng(2)
    neg = torch.tensor(float("-inf"), device="cuda")
    with highp():
        for N, D, Q in K3_SHAPES:
            db = rng.normal(size=(N, D))
            db /= np.linalg.norm(db, axis=1, keepdims=True)
            q = db[rng.integers(0, N, size=Q)] + rng.normal(0, 0.05, (Q, D))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            db, q = (torch.from_numpy(v.astype(np.float32)).cuda()
                     for v in (db, q))
            mask = torch.from_numpy(rng.uniform(size=(Q, N)) > 0.3).cuda()
            b_ms, by = bound(N * D * 4 + Q * D * 4 + Q * N + Q * 12,
                             2.0 * Q * N * D)
            emit(dict(
                kernel="K3", shape=[N, D, Q],
                ms=time_ms(lambda: kernels.retrieval_top1(db, q, mask)),
                plain_ms=time_ms(lambda: retrieval_top1_ref(db, q, mask)),
                library_ms=time_ms(lambda: torch.argmax(
                    torch.where(mask, q @ db.T, neg), dim=1)),
                bound_ms=b_ms, bound_by=by))


def bench_e1() -> None:
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape, relu, pool in E1_CASES:
        x = torch.randn(shape, generator=g, device="cuda")
        b = 0.5 * torch.randn(shape[1], generator=g, device="cuda")
        b4 = b.view(1, -1, 1, 1)

        def library():
            y = x.add_(b4)                  # cuDNN's route adds in place
            y = F.relu(y) if relu else y
            return F.max_pool2d(y, 2, 2) if pool else y

        # without the pool the kernel and the library write into x, which
        # drifts by the bias a call: the same work
        b_ms, by = bound(4 * x.numel() * (1.25 if pool else 2), 0)
        emit(dict(
            kernel="E1", shape=list(shape), relu=relu, pool=pool,
            ms=time_ms(lambda: kernels.conv_epilogue(x, b, relu, pool),
                       **FEW),
            plain_ms=time_ms(lambda: conv_epilogue_ref(x, b, relu, pool),
                             **FEW),
            library_ms=time_ms(library, **FEW), bound_ms=b_ms, bound_by=by))
        del x


def bench_c1() -> None:
    g = torch.Generator(device="cuda").manual_seed(6)
    with highp():
        for N, C, K, H, W in C1_CASES:
            x = torch.randn((N, C, H, W), generator=g, device="cuda").relu_()
            w = torch.randn((K, C, 3, 3), generator=g, device="cuda") * (
                2.0 / (9 * C)) ** 0.5
            wr = conv3x3_weight(w)
            row = dict(kernel="C1", shape=[N, C, K, H, W],
                       tile=kernels.conv3x3_tile(H, W),
                       ms=time_ms(lambda: kernels.conv3x3(x, wr), **FEWER),
                       plain_ms=time_ms(lambda: conv3x3_ref(x, w), **FEWER))
            torch.backends.cudnn.benchmark = True
            try:
                row["library_ms"] = time_ms(
                    lambda: F.conv2d(x, w, None, 1, 1), **FEWER)
            finally:
                torch.backends.cudnn.benchmark = False
            row["bound_ms"], row["bound_by"] = bound(
                4 * (x.numel() + w.numel() + N * K * H * W),
                2 * N * H * W * C * K * 9)
            emit(row)
            del x, w, wr


BENCHES = dict(K1=bench_k1, K2=bench_k2, K3=bench_k3, E1=bench_e1,
               C1=bench_c1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=list(BENCHES),
                    choices=list(BENCHES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_kernels: needs a CUDA card")
    emit(dict(card=card("cuda")))
    kernels.build()
    with torch.no_grad():
        for name in args.kernels:
            BENCHES[name]()


if __name__ == "__main__":
    main()
