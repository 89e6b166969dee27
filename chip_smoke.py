#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. Every phase is fatal: any failure raises and the script exits
non-zero without printing a result.

It runs the kernels' card checks, drives the port's paths at full size on
the card and holds them to the JAX package's anchors from the CPU, and
checks what each path launched: the kernels' launch counts and shapes, and
that no plain version ran. The kernels' timings are not taken here:
python3 -m omniswarm_torch.bench_kernels takes them.

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the port from csrc/ (one nvcc per source, started together).
2. The kernels against their plain versions: the ``cuda`` tests of
   CARD_TESTS, the one place those checks are written (K1 at every
   SOLVE_LEVELS shape and odd widths on three branches; K2 and K3 at the
   paths' batches and edge cases; E1 bit-equal at the main path's 12
   shapes; C1 against the direct convolution at the cells' shapes; the
   RGB-D batch against benchmark/reference/rgbd.py; the stereo batch's
   one download and its merge bit-equal to the six-download one), in one pytest
   process. Every test must pass and none skip. The "kernels" line at the
   end gives the tests passed per test function, the largest error each
   recorded, and the launches the path phases counted.
3. Main path: omniswarm_torch.entry.entry() at F=100, D=5, seed 0,
   20 LM iterations. Checks a finite cost below the initial one, within 1%
   of the reference's 177.25, relative ATE < 0.08, 4 kernel launches per
   iteration at SOLVE_LEVELS's shapes (m=40 with t=32, 16, 8, 4; recorded
   in the run); the same solve with fused=False must agree within 1e-3.
4. The same at F=1024 (pack 4, m=80 with t=128 ... 4), against
   the reference's 2330.99 and relative ATE < 0.1. At both sizes a second
   fused solve must give a bit-equal cost and equal poses.
4a. The rest of the solver, each path solved twice (bit-equal cost and
   poses), 20 LM iterations, function_tolerance 0, seed 0, D=5, held to
   the JAX package's CPU anchors in SOLVER_ANCHORS (tools/solver_anchors.py):
   PCG at F=1024 (linear="pcg", 24 CG sweeps; K1 launches and level shapes
   recorded as in 3; cost within 1% of its anchor; then, at 50 iterations
   as in the reference's test, within 5e-3 of an exact-Woodbury solve of
   the same problem and relative ATE < 0.02 against its poses; the fast
   Woodbury solve of 4 stalls far above both in the reference too, so its
   difference is printed, not held); the exact
   path at F=100 (exact_linear=True, no K1; 1%, ATE < 0.08); the lock-step
   batch of 8 at F=100 (bench.py's inits; each lane within rtol 0.05, atol
   0.5 of a single solve of its init and of its anchor, lane 0 ATE < 0.08,
   no K1); pose_covariances of the newest frame of each drone at the F=100
   solution of 3 (against the inverse of assemble_dense's H + 1e-6 I and the
   anchor's diagonals, rtol 0.05, atol 5e-4); the gold paths at F=100:
   lm_solve_dense, lm_solve and lm_solve_multi_init (4 inits) within 1% of
   their anchors, dense against generic within 5e-2 in cost and 0.03 in
   relative ATE. Each path's ms per LM iteration is printed.
7. Front-end path: omniswarm_torch.frontend_entry.frontend_entry() at
   full size (5 drones x 15 keyframe steps of 40 views at 400 x 208; its
   views rendered once for this phase and phase 9a's image demo). No
   plain version may run; K2 and K3 launch 15 times each, the conv
   epilogue 12 times a step; C1 never (OmniLoopCam's stereo batch keeps
   cuDNN's bits for its f16 outputs, swarm/loop_cam.py). Held against the
   JAX package's CPU anchors: each keyframe's landmark count, keypoint sums,
   inverse-range landmark sums and global-descriptor projection within
   frontend_entry.checksum_faults's tolerances, at least 95% of the 75
   top-1 indices equal, the top-1 precision within 0.02. K2's output on
   the first step's SuperPoint heat maps is bit-equal to its plain
   version's on the same maps.
7b. RGB-D front-end path: LoopCam.on_depth_frames_batch, the entry point
   of the swarm5_rgbd640.rgbd_keyframes cell, through that cell's own
   driver (benchmark/drivers/rgbd_keyframes.py: 5 drones' 640 x 480
   infrared views and uint16 depth maps, the configuration's checkpoints,
   a full 4,096-row PlaceDB, its two warm steps), RGBD_STEPS steps after
   them. No plain version may run; C1 launches 9 times a step, the conv
   epilogue 12, K2 and K3 once. Every step is then judged by the driver's
   check against the plain reference (benchmark/reference/rgbd.py) and
   held to the cell's limits (benchmark/limits/).
7a. Estimator path: omniswarm_torch.estimator_entry.estimator_entry(), a
   SwarmEstimator serving a 5-drone flight of 150 frames (seed 0, 20% loop
   outliers), a solve every 10th frame (15 solves; the window fills to 100
   keyframes, then evicts at random), max_solver_time 0. The held session
   (acpt_cost 1000: every solve after the first is warm) is held to the JAX
   package's CPU anchors in ESTIMATOR_ANCHORS (tools/estimator_anchors.py):
   each solve's window, finish_init, PCM inlier sets and linear path equal,
   cost within 1% (up to and including a solve whose anchor cost lies within
   1% of acpt_cost, a tie: after it only the bars), final relative ATE
   <= 0.08 and within 0.01 of its anchor, each drone's newest covariance
   diagonal within rtol 0.05, atol 5e-4; every prediction finite, the self
   drone at the origin; K1 launched (its level shapes outside SOLVE_LEVELS
   checked against the plain version after the run). A second held
   session must give bit-equal costs and estimate. Then the deployed session
   (acpt_cost 100, as shipped), held to bars: finite costs, finish_init
   false after each solve above the gate and the next solve a multi-init,
   every multi-init result at relative ATE <= 0.08, predictions finite; it
   prints each solve's path and the iteration budget max_solver_time 0.5
   would give. One JSON line with host and device ms (medians, warm and
   multi-init), PCM launch-to-finish ms, predict_swarm_relative us per
   call, each solve's linear path and K1's launches.
9a. The demos (omniswarm_torch.demo_entry), after 7a, each run twice
   (loop keys, costs and estimates bit-equal) and held to the JAX package's
   CPU anchors in DEMO_ANCHORS (tools/demo_anchors.py; the random draws of
   RANSAC differ between the packages, so a borderline loop may flip: every
   flip is printed). The feature demo (3 drones x 30 frames over the
   VisualWorld): the symmetric difference of the unique loop keys <= 2% of
   the anchor's count, each drone's cost within 1% and relative ATE within
   0.5 cm of its anchor, every drone solved. The image demo (5 drones x 30
   frames, 75 keyframes of 4-direction stereo at 400 x 208, the 600 views
   of phase 7's render, for both runs): every drone solved,
   recall within 0.03 of its anchor, precision >= anchor - 0.02, post-PCM
   precision >= anchor - 0.01, each drone's relative ATE <= anchor + 0.5 cm
   and below raw VIO's; K2 launched once per keyframe step and no plain
   kernel version run. Its per-drone costs are printed beside the anchors'
   and not held: they follow the loop set, which the draws change. What the
   draws cannot excuse is held by the detector's parity: drone 0's
   LoopDetector on the card and on the CPU, fed the demo's keyframes at its
   tick shapes (Qb 1 and 4, 16 lanes a query) and the same Gumbel noise
   (drawn on the CPU, uploaded): retrieval and matches equal on every lane,
   PnP inlier sets different on at most 3% of the live lanes, the same
   accepted loops edge for edge, their inlier counts within 2 and dpose
   within 0.02. The loop-key difference from the anchors is bounded at 20%
   of their count. One "demo" JSON line: the
   numbers held, each drone's cost and relative ATE beside its anchor's,
   the median detector tick ms (host clock around a synchronised
   on_keyframes_batch), verify lanes per tick, views/s, the median keyframe
   latency, K1/K2/K3 launches and the parity's ticks, lanes and loops.
10a. The multi-device layouts (omniswarm_torch.parallel), after 9a: one
   spawn of 1 rank on NCCL and one of 4 gloo ranks sharing card 0 (several
   ranks on one card need gloo: NCCL refuses two ranks on one device), each
   running every layout (D=5, function_tolerance 0) after a small warm-up
   solve: the frame-sharded window at F=1024, seed 0 (1022 loops, 4,088
   Woodbury columns), 50 LM iterations, within 5e-3 of the port's exact
   lm_solve_bt of the same problem in this run and of its JAX-CPU anchor,
   relative ATE < 0.1; the dryrun's problem (F=256, seed 2, loop_every=16,
   20 iterations) twice, bit-equal, within 5e-3 of its anchor; the
   factor-sharded generic LM on the F=100 problem of 4a (detections on, 20
   iterations) within 1e-3 of SOLVER_ANCHORS["generic_100"] and of the
   port's lm_solve in this run, poses within 5e-3, relative ATE < 0.08; the
   fleet of bench.py (8 lanes of 5 x 100, seeds 100-107, loop capacity the
   largest lane's, 20 iterations; 2 lanes a rank at world 4), each lane
   within 5e-3 of its own lm_solve_bt and of its anchor, lane 0 relative
   ATE < 0.08, no collective but the one gather of the result; the fleet
   also unsplit in this process. Every rank returns the same result, and K1,
   K2 and K3 launch 0 times on every rank (no plain version runs either).
   Anchors: PARALLEL_ANCHORS (tools/parallel_anchors.py). Printed, not held:
   each run's backend, ms per LM iteration and collective calls and bytes
   per iteration; with 4 ranks on one card they measure the layout's
   overhead, not scaling. One "layouts" JSON line.
11a. The production node (omniswarm_torch.runtime.run_node through
   omniswarm_torch.node_entry), after 10a: 7a's flight (5 drones x 150
   frames, seed 0) with drone 4 held still as configs/swarm5.yaml's static
   anchor, as the node's JSON lines (frame, vio, det; no loop edges: the
   protocol carries none). (a) Two paced sessions of NodeLoop on
   swarm5.yaml with a solve every 10th frame and max_solver_time 0, one on
   the worker thread (waiting for each solve) and one inline: bit-equal in
   every solve line, window and prediction; 14 solves after the refused
   first; the final relative ATE below raw VIO's; the last prediction of 5
   drones; K1's launches on the threaded run (new level shapes checked
   against the plain version). Then python -m
   omniswarm_torch.runtime.run_node --no-udp in a subprocess at the
   config's own cadence (force_freq 1), fed 8 frames a wall second from
   its ready line: exit 0, at least 3 solves, the last at t >= 0.85 of the
   flight's final t, the last prediction of all 5 drones; printed: solves
   dispatched, messages that found one in flight, the median solve wall,
   the predict lines' wall gaps (p50, p99) with and without a solve in
   flight, and each prediction's own wall time (with a solve in flight
   here; without one in the paced threaded session). (b) Two runtime.drone_process processes on the card over
   loopback multicast (tests/test_multiprocess.py's scenario: 2 drones x
   16 frames, seed 55, world seed 7): exit 0, each that solved within
   relative ATE 0.3 (its final solve's poses, whatever their cost), at
   least one solved, loop edges crossed. (c) The
   feature demo's per-drone reports, written by 9a's first run: each
   summary.json's relative ATE equal to the demo's. One "node" JSON line.
12a. The training path (omniswarm_torch.models.train_superpoint,
   train_netvlad and train_entry), after 11a, held to the JAX package's
   CPU anchors in TRAIN_ANCHORS (tools/train_anchors.py). (a) Under highp:
   detection_metrics of superpoint_synthetic on 32 images, the textured,
   flat and default-warp matching_metrics rows of superpoint_photo_v2 on 24
   pairs each, retrieval_metrics of netvlad_v2_revisit on the 96-way hard
   revisit tier; each count (tp, fp, fn; matches and correct ones; correct
   retrievals) within TRAIN_FLIPS of its anchor, the flips printed. (b)
   Under highp with cuDNN deterministic: 20 steps of train_detector, then
   20 of train_descriptors, each from superpoint_synthetic (seed 0, batch
   8, 64 x 96), the first 3 losses within 1e-4 of their anchors and the
   rest within 5e-2 (TRAIN_LOSS_RTOL); a second
   run bit-equal (losses and weights); the spread of a run without
   deterministic cuDNN printed. (c) superpoint_main (the magicpoint stage,
   Flax's init, 300 steps, batch 8, PCA fitted on 32 images): the last
   logged loss < 0.6x the first, recall > 0.25, precision > 0.2 on 32
   images (tests/test_train_superpoint.py:31-40). (d) train_netvlad at the
   tool's width (v1, 16 places -> 32 views of 96 x 160, pool 256, 200
   steps, its checkpoint written half-way and at the end) at seeds 0-2:
   the means of the mean loss of the last 20 steps and of easy 64-way
   recall@1 inside the JAX seeds' [min, max] widened by half its width (the
   recall by at least 1/64). (c) and (d) run at PyTorch's default
   precision (TF32 convolutions), as a user's training would: they are
   held to bars. (e) Under highp: the checkpoints of (c) and (d) load into
   pretrained_extractor / pretrained_global_extractor and reproduce the
   forward of the in-memory weights rounded to f16 within 1e-5, the PCA
   equal. (a)-(e) launch K2 only, at (1, 64, 96) and (16, 64, 96), each
   checked against the plain version on the trained detector's heat; no
   plain version, K1 or K3 runs. (f) ms per step, host render apart from
   the synchronised device step, at the tools' batches: train_detector at
   32 (line art; textured with homographic-adaptation labels),
   train_descriptors at 16 (line art; textured), train_netvlad at 16
   places (its views rendered on the card). One "training" JSON line.
13a. The 10-drone tier and the loop-dense window, after 12a, held to the
   JAX package's CPU anchors in SOLVER_ANCHORS and DEMO_ANCHORS
   (tools/solver_anchors.py --only d10_100 d10_1024 dense_loops_1024,
   tools/demo_anchors.py --drones 10). (a) entry() at 10 x 100 (seed 3, 50
   iterations: the Woodbury path at pack 1, no K1) and at 10 x 1024 (seed
   0, 20 iterations: PCG by the "auto" rule at pack 2, K1 once an iteration
   at each of (80, 256), (80, 128) ... (80, 4), the level shapes recorded in
   the run). Each runs twice (bit-equal cost and poses) and is held to its
   anchor: cost within 1%, the anchor's iteration count, cost below the
   initial one, relative ATE below raw VIO's (and below the reference
   test's 0.15 at 10 x 100). (b) The loop-dense window (5 x 1024, seed 4,
   loop_every=2: 2,555 loops, 25 iterations) through the command line's
   own function, omniswarm_torch.tools.bench_dense_loops.measure (exact=True,
   one timed solve a run, each repeated): PCG at 24, 16, 12 and 8 CG
   sweeps (K1 at the F=1024 shapes above), the Woodbury path
   (linear="smw", K1 too; no anchor: held to a cost decrease) and the
   exact path (no K1), each repeat bit-equal, the PCG and exact runs held
   to their anchors as in (a). Each solve's ms per LM iteration and K1's
   launches are printed. (c) The 10 x 30 image
   demo (150 keyframes, 80 views a keyframe step) through the command
   line's own function,
   demo_entry.main(["image", "--drones", "10", "--frames", "30", "--out",
   ...]), run once, held to DEMO_ANCHORS["image_d10"] at phase 9a's image
   bars, every one of the ten drones solved, K2 launched once a keyframe
   step (15) at (80, 208, 400), K1 and K3 never, no plain kernel version
   run. One "tier10" JSON line.
14a. The measurement entry points, after 13a. (a) The bundled SuperPoint
   and both NetVLAD checkpoints (v2 and v1) with their trunks in bf16
   against f32 (highp) on 4 render_shapes images at 400 x 208, at
   tests/test_bf16_frontend.py's bars: heat within 0.03, coarse descriptor
   cosine above 0.995, more than 90% of each image's keypoints matched
   within 1 px, global cosine above 0.99 and pairwise similarities within
   0.02. (b) omniswarm_torch.cpu_baseline.measure at 20 LM iterations (the
   module: 100) with 1 repetition and no warm-up call but torch_cpu_bt's
   (the module takes 3 after one) into
   build/chip_smoke/, then
   omniswarm_torch.bench.run at its own sizes with one timed solve a row,
   the row's first (the module warms up, then takes the medians of 5 and
   3), and 1 run of front-end calls (the module: 3), printed as one
   "bench" line:
   every key
   of BENCH_r05.json's parsed, no *_error key, the fused-vs-unfused
   kf1024 cost within bench.py's 2e-3, K1 launched in the headline,
   efficiency, kf1024 and dense-loop rows and K2 in the front-end row,
   only at K2_BENCH_SHAPES (4, 8, 16 and 64 views of 208 x 400), K3
   never, no plain version; K1's level shapes outside SOLVE_LEVELS checked
   against the plain version.
   (c) omniswarm_torch.online_window.session at 1,024 keyframes and 2,000
   loops with 12 live solves, each solve held to ONLINE_ANCHORS
   (tools/online_window_anchors.py: the JAX estimator on the CPU through
   tools/online_window_bench.py's own functions) by
   online_window.held_to: window and PCM inlier sets equal, cost within
   1%, iterations equal where a solve runs to the cap (near the minimum,
   rounding decides whether a warm solve converges or stalls, so the
   count is printed beside its anchor's); K1 launched (new level shapes
   checked after the run), K2 and K3 never. One "online window" line.
15a. The repository's remaining tools (omniswarm_torch/tools/), after 14a.
   (a) tools.window_scale_sweep's row at F = 1,024, 2,048, 4,096, 8,192
   and 16,384 (5 drones, seed 1, loop_every=128, 25 iterations, one timed
   solve a size; Woodbury up to 4,096, PCG above; K1 at t = F/8 ... 4, its
   shapes recorded and checked against SOLVE_LEVELS, no plain level): each
   F within 1% of its JAX-CPU cost in SWEEP_ANCHORS
   (tools/solver_anchors.py --only window_scale) with the anchor's loops,
   iterations and linear path; F=16,384 solved twice (bit-equal); at every
   F a cost below the initial one and relative ATE below raw VIO's. (b)
   tools.replay_eval on CSV logs written from the simulator (3 drones, 30
   s) held to REPLAY_ANCHOR (the reference's tools/replay_eval.py on the
   CPU; both with max_solver_time 1e-6 s): the same solves over the same
   windows and iterations, each cost within 1%, each summary.json value
   within 1e-3 m (rad). (c)
   tools.eval_superpoint_textured on the three bundled SuperPoint
   checkpoints (24 pairs, highp): K2 at (1, 64, 96) only, no plain
   version, K1 and K3 never; photo_v2's textured and flat rows within one
   flipped count of phase 12a's anchors. (d) Meanwhile, two
   python -m omniswarm_torch.tools.network_tester processes (5 s, 2
   keyframes a second) and python -m omniswarm_torch.tools.bus_spy over
   loopback multicast: exit 0, each tester receives the other's keyframes,
   the spy hears both drones. One "tools" JSON line.
16a. The last reference tools (omniswarm_torch/tools/), after 15a. (a)
   tools.convert_superpoint: a seeded SuperPointNet (the module's plain
   twin) saved as a .pth with random PCA CSVs, converted with and without
   them (the reference's keys, f32); the port's SuperPoint from the plain
   .npz against the twin's forward on the card under highp at
   tests/test_weight_conversion.py's bars (atol 1e-4, rtol 1e-3) on 4
   images of 208 x 400; the SuperPointExtractor from the PCA .npz on them
   launches K2 at (4, 208, 400) (counted; no plain version), and K2 there
   is bit-equal to its plain version on the twin's heat. (b)
   tools.drift_probe with DIR = this tree, one pair of child processes
   (the headline's 5 x 100 solve, 1 warm + 1 timed): equal iteration
   counts, bit-equal costs, K1 launched in each child (their counts are
   the children's own); the times are printed, not held. (c)
   tools.comm_model's F = 256 row on 8 gloo CPU ranks: the LM iteration's
   calls and bytes equal to COMM_MODEL.json's plus the named [cost | bad]
   psum (one all-reduce, 4 B), the fleet without data collectives;
   and one world-1 timing of lm_solve_bt on the card (K1 launched, level
   shapes outside SOLVE_LEVELS checked). One "reference tools" JSON
   line.
Then the "kernels" line (phase 2's tests and errors, the launches the path
phases counted), the solver paths' numbers (one JSON line), the seconds of
each phase (one JSON line), the script's seconds, the card and the result
line.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# phase 2: the four JAX-free test files that hold every kernel's card check
CARD_TESTS = ("tests/test_torch_kernels_card.py",
              "tests/test_torch_conv_epilogue.py",
              "tests/test_torch_conv3x3.py", "tests/test_torch_rgbd.py",
              "tests/test_torch_stereo_merge.py")
K1_BRANCHES = ("warm", "fallback", "nan")
MAIN_PATHS = (
    # F, launches per LM iteration, reference cost, relative-ATE bar
    (100, 4, 177.25, 0.08),
    (1024, 6, 2330.99, 0.1),
)
SOLVER_ITERS = 20
# The solver paths' anchors, from the JAX package on the CPU
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tools/solver_anchors.py)
SOLVER_ANCHORS = dict(
    pcg_1024=dict(cost=2011.31409),
    exact_100=dict(cost=177.128342),
    batch_100=dict(cost=[177.250732, 177.388657, 177.60434, 247.1297,
                         177.591339, 177.455841, 177.439407, 177.776428]),
    # per drone d, the (x, y, z, yaw) variances of pose (99, d)
    cov_100=dict(diag=[
        [0.00873469, 0.0194593, 0.0135628, 0.000738012],
        [0.01161, 0.0147984, 0.0141377, 0.000876103],
        [0.0108905, 0.0112982, 0.0094109, 0.000725998],
        [0.00918638, 0.0108395, 0.00927172, 0.000714457],
        [0.00971783, 0.0168393, 0.0149874, 0.000820859]]),
    dense_100=dict(cost=177.128357),
    generic_100=dict(cost=177.128387),
    multi_100=dict(cost=177.128326),
    # phase 13a: the 10-drone tier (seeds 3 and 0) and the loop-dense
    # window (5 x 1024, seed 4, loop_every=2: 2,555 loops, 25 iterations);
    # the packed PCG solves on the reference's fused-level branch, the
    # card's (tools/solver_anchors.py::reference_fused_levels)
    d10_100=dict(cost=747.709228515625, initial_cost=3860.382080078125,
                 iterations=50, relative_ate=0.046610525453943986),
    d10_1024=dict(cost=7587.98681640625, initial_cost=126922.5234375,
                  iterations=20, relative_ate=0.045474261600993576),
    # by linear path: PCG at cg_iters 24, 16, 12, 8 and the exact path
    dense_loops_1024=dict(
        pcg24=dict(cost=3425.55419921875, iterations=25,
                   relative_ate=0.05986429677468887),
        pcg16=dict(cost=3517.47412109375, iterations=25,
                   relative_ate=0.06074584877153768),
        pcg12=dict(cost=3629.955810546875, iterations=25,
                   relative_ate=0.062484073148695994),
        pcg8=dict(cost=4449.51806640625, iterations=25,
                  relative_ate=0.08710246922974232),
        exact=dict(cost=3419.97802734375, iterations=25,
                   relative_ate=0.059811932548156664)),
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
# The estimator path's anchors, from the JAX package on the CPU
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tools/estimator_anchors.py): the
# held session (acpt_cost 1000) solve by solve, then the final relative ATE
# and the covariance diagonals of each drone's newest pose.
ESTIMATOR_ANCHORS = dict(
    acpt_cost=1000.0,
    solves=[
        dict(
            frames=[[0, 9]],
            finish_init=True,
            cost=13.269008,
            cost_over_acpt=0.013269,
            inliers={'0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=4,
        ),
        dict(
            frames=[[0, 19]],
            finish_init=True,
            cost=30.567295,
            cost_over_acpt=0.030567,
            inliers={'0-0': [1, '6318e8aa3fb0'],
                     '0-2': [1, '8fabe60cb844'],
                     '0-3': [1, '8383837ddfb6'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=None,
        ),
        dict(
            frames=[[0, 29]],
            finish_init=True,
            cost=43.626095,
            cost_over_acpt=0.043626,
            inliers={'0-0': [3, 'd25a421c7320'],
                     '0-2': [1, '8fabe60cb844'],
                     '0-3': [1, '8383837ddfb6'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=None,
        ),
        dict(
            frames=[[0, 39]],
            finish_init=True,
            cost=122.131393,
            cost_over_acpt=0.122131,
            inliers={'0-0': [5, '0c9255830011'],
                     '0-2': [1, '8fabe60cb844'],
                     '0-3': [2, '407ddaf9e76a'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=None,
        ),
        dict(
            frames=[[0, 49]],
            finish_init=True,
            cost=143.330627,
            cost_over_acpt=0.143331,
            inliers={'0-0': [6, '90fd2af07926'],
                     '0-2': [1, '8fabe60cb844'],
                     '0-3': [2, '407ddaf9e76a'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=None,
        ),
        dict(
            frames=[[0, 59]],
            finish_init=True,
            cost=160.611511,
            cost_over_acpt=0.160612,
            inliers={'0-0': [8, 'f85599b55c2d'],
                     '0-2': [1, '8fabe60cb844'],
                     '0-3': [2, '407ddaf9e76a'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=None,
        ),
        dict(
            frames=[[0, 69]],
            finish_init=True,
            cost=180.653656,
            cost_over_acpt=0.180654,
            inliers={'0-0': [9, '70c24ce62849'],
                     '0-2': [1, '8fabe60cb844'],
                     '0-3': [3, '5ff2fe312452'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=None,
        ),
        dict(
            frames=[[0, 79]],
            finish_init=True,
            cost=200.377213,
            cost_over_acpt=0.200377,
            inliers={'0-0': [9, '70c24ce62849'],
                     '0-2': [2, '7241e8805a30'],
                     '0-3': [3, '5ff2fe312452'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=1,
            lanes=None,
        ),
        dict(
            frames=[[0, 89]],
            finish_init=True,
            cost=219.524734,
            cost_over_acpt=0.219525,
            inliers={'0-0': [10, '8a6621f23d62'],
                     '0-2': [2, '7241e8805a30'],
                     '0-3': [3, '5ff2fe312452'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=2,
            lanes=None,
        ),
        dict(
            frames=[[0, 99]],
            finish_init=True,
            cost=233.990997,
            cost_over_acpt=0.233991,
            inliers={'0-0': [12, '9b10496af8e9'],
                     '0-2': [2, '7241e8805a30'],
                     '0-3': [3, '5ff2fe312452'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='smw',
            pack=2,
            lanes=None,
        ),
        dict(
            frames=[[0, 2], [4, 12], [14, 14], [16, 19], [21, 23], [25, 30],
                    [32, 35], [37, 38], [40, 49], [51, 73], [75, 109]],
            finish_init=True,
            cost=212.905289,
            cost_over_acpt=0.212905,
            inliers={'0-0': [6, '2c1689fd1164'],
                     '0-2': [2, '7241e8805a30'],
                     '0-3': [3, '5ff2fe312452'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='pcg',
            pack=2,
            lanes=None,
        ),
        dict(
            frames=[[0, 2], [4, 10], [16, 19], [21, 21], [23, 23], [25, 30],
                    [32, 35], [37, 38], [40, 47], [51, 56], [58, 61], [63, 73],
                    [75, 76], [78, 83], [85, 119]],
            finish_init=True,
            cost=210.693726,
            cost_over_acpt=0.210694,
            inliers={'0-0': [7, '2008b1a6fadf'],
                     '0-2': [2, '7241e8805a30'],
                     '0-3': [2, '407ddaf9e76a'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='pcg',
            pack=2,
            lanes=None,
        ),
        dict(
            frames=[[0, 2], [4, 10], [16, 17], [19, 19], [21, 21], [23, 23],
                    [25, 27], [29, 30], [32, 32], [34, 35], [37, 38], [40, 44],
                    [46, 47], [51, 51], [54, 56], [59, 61], [63, 73], [75, 76],
                    [78, 83], [85, 89], [91, 93], [95, 98], [100, 129]],
            finish_init=True,
            cost=213.825714,
            cost_over_acpt=0.213826,
            inliers={'0-0': [5, '20fbd0aaab17'],
                     '0-2': [2, '7241e8805a30'],
                     '0-3': [2, '407ddaf9e76a'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='pcg',
            pack=2,
            lanes=None,
        ),
        dict(
            frames=[[1, 1], [5, 10], [16, 17], [19, 19], [21, 21], [23, 23],
                    [25, 25], [29, 30], [32, 32], [34, 35], [37, 38], [40, 43],
                    [46, 47], [51, 51], [54, 54], [56, 56], [59, 61], [64, 73],
                    [75, 76], [78, 78], [80, 83], [85, 89], [91, 93], [95, 95],
                    [97, 98], [100, 139]],
            finish_init=True,
            cost=204.059143,
            cost_over_acpt=0.204059,
            inliers={'0-0': [3, '341c9f193f29'],
                     '0-2': [1, '7909b24da039'],
                     '0-3': [1, '8383837ddfb6'],
                     '0-4': [1, 'ebd496a6aebb']},
            linear='pcg',
            pack=2,
            lanes=None,
        ),
        dict(
            frames=[[1, 1], [6, 10], [16, 17], [19, 19], [21, 21], [23, 23],
                    [25, 25], [29, 30], [32, 32], [35, 35], [37, 38], [41, 43],
                    [46, 47], [54, 54], [56, 56], [59, 61], [64, 71], [73, 73],
                    [75, 76], [78, 78], [80, 82], [85, 89], [91, 91], [93, 93],
                    [95, 95], [97, 98], [100, 103], [105, 107], [109, 118],
                    [120, 149]],
            finish_init=True,
            cost=193.932724,
            cost_over_acpt=0.193933,
            inliers={'0-0': [4, '55e1ec653f53'], '0-2': [1, '7909b24da039']},
            linear='pcg',
            pack=2,
            lanes=None,
        ),
    ],
    relative_ate=0.055276,
    cov_diag={'0': [0.039339349, 0.027826173, 0.034167178, 0.0013795],
              '1': [0.028355613, 0.02518354, 0.029769404, 0.001363359],
              '2': [0.041616686, 0.026375439, 0.032375801, 0.001360981],
              '3': [0.032842066, 0.025331721, 0.028284132, 0.001168629],
              '4': [0.049393967, 0.040781032, 0.031027215, 0.001373572]},
)
EST_COST_RTOL = 0.01        # one flipped accept
EST_TIE = 0.01              # an anchor cost this close to acpt_cost is a tie
EST_ATE_BAR = 0.08          # the reference's relative-ATE bar at 5 x 100
EST_ATE_TOL = 0.01          # final relative ATE against its anchor
EST_COV_RTOL, EST_COV_ATOL = 0.05, 5e-4
EST_DEPLOYED_ACPT = 100.0   # the shipped acpt_cost
FE_IDX_SHARE = 0.95         # top-1 indices equal to the anchors
FE_PRECISION_ATOL = 0.02
FE_STEPS = 15
RGBD_CELL = "swarm5_rgbd640.rgbd_keyframes"     # phase 7b's cell
RGBD_STEPS = 4               # its steps after the driver's warm ones
# The demos' anchors, from the JAX package on the CPU (PYTHONPATH=.
# JAX_PLATFORMS=cpu python tools/demo_anchors.py): per demo the unique loop
# keys (pair-canonical (drone, centiseconds) of both ends), the false ones,
# recall, precision before and after PCM, and per drone cost and relative
# ATE (cm).
DEMO_ANCHORS = {
    "feature": {
        "loop_keys": [[0, 0, 1, 1000], [0, 0, 1, 2000], [0, 200, 1, 800], [0,
            200, 1, 1800], [0, 200, 1, 2800], [0, 400, 1, 600], [0, 400, 1,
            1600], [0, 1000, 0, 0], [0, 1000, 1, 0], [0, 1000, 1, 1000], [0,
            1000, 1, 2000], [0, 1200, 0, 200], [0, 1200, 1, 800], [0, 1200, 1,
            1800], [0, 1200, 1, 2800], [0, 1400, 0, 400], [0, 1600, 0, 600],
            [0, 1800, 0, 800], [0, 2000, 0, 1000], [0, 2000, 1, 0], [0, 2000,
            1, 2000], [0, 2200, 0, 1200], [0, 2400, 0, 1400], [0, 2600, 0,
            1600], [0, 2800, 0, 0], [0, 2800, 0, 1800], [1, 1000, 1, 0], [1,
            1200, 1, 200], [1, 1400, 1, 400], [1, 1600, 1, 600], [1, 1800, 1,
            800], [1, 2000, 1, 0], [1, 2000, 1, 1000], [1, 2200, 1, 200], [1,
            2200, 1, 1200], [1, 2400, 1, 400], [1, 2400, 1, 1400], [1, 2600, 1,
            600], [1, 2600, 1, 1600], [1, 2800, 1, 1800], [2, 1400, 2, 0], [2,
            1600, 2, 200], [2, 1800, 2, 400], [2, 2000, 2, 600], [2, 2200, 2,
            800], [2, 2400, 2, 1000], [2, 2600, 2, 0], [2, 2600, 2, 1200], [2,
            2800, 2, 200], [2, 2800, 2, 1400]],
        "false_keys": [],
        "loop_recall": 0.5487804878048781,
        "loop_precision": 1.0,
        "loop_precision_post_pcm": 1.0,
        "loops_unique": 50,
        "loops_found": 77,
        "loops_received": 136,
        "revisit_opportunities": 82,
        "all_solved": True,
        "per_drone": [{'drone': 0, 'cost': 7.462320327758789,
            'relative_ate_cm': 4.011892647427034, 'vio_relative_ate_cm':
            11.264208869277033}, {'drone': 1, 'cost': 7.448361396789551,
            'relative_ate_cm': 4.121223165071551, 'vio_relative_ate_cm':
            11.264208869277033}, {'drone': 2, 'cost': 7.360134124755859,
            'relative_ate_cm': 4.191938198650036, 'vio_relative_ate_cm':
            11.264208869277033}],
    },
    "image": {
        "loop_keys": [[0, 0, 1, 0], [0, 0, 1, 200], [0, 0, 1, 1000], [0, 0, 1,
            1200], [0, 0, 1, 2000], [0, 0, 3, 400], [0, 200, 1, 0], [0, 200, 1,
            800], [0, 200, 1, 1000], [0, 200, 1, 1800], [0, 200, 1, 2000], [0,
            200, 1, 2800], [0, 200, 4, 400], [0, 200, 4, 1600], [0, 200, 4,
            2800], [0, 400, 1, 400], [0, 400, 1, 600], [0, 400, 1, 1400], [0,
            400, 1, 1600], [0, 400, 1, 2600], [0, 400, 2, 0], [0, 400, 2, 200],
            [0, 400, 2, 1600], [0, 400, 2, 2600], [0, 400, 2, 2800], [0, 400,
            3, 200], [0, 400, 3, 2000], [0, 400, 3, 2800], [0, 400, 4, 0], [0,
            400, 4, 1200], [0, 400, 4, 2400], [0, 600, 3, 1600], [0, 800, 1,
            200], [0, 1000, 0, 0], [0, 1000, 1, 0], [0, 1000, 1, 200], [0,
            1000, 1, 1000], [0, 1000, 1, 1200], [0, 1000, 1, 2000], [0, 1000,
            1, 2200], [0, 1000, 3, 400], [0, 1000, 3, 2200], [0, 1200, 0, 200],
            [0, 1200, 1, 800], [0, 1200, 1, 1800], [0, 1200, 1, 2800], [0,
            1200, 2, 400], [0, 1200, 3, 200], [0, 1200, 3, 2000], [0, 1200, 4,
            400], [0, 1200, 4, 1400], [0, 1200, 4, 1600], [0, 1200, 4, 2600],
            [0, 1200, 4, 2800], [0, 1400, 0, 400], [0, 1400, 2, 0], [0, 1400,
            2, 1400], [0, 1400, 2, 2600], [0, 1400, 3, 0], [0, 1400, 3, 1800],
            [0, 1600, 0, 600], [0, 1800, 0, 800], [0, 1800, 1, 200], [0, 1800,
            3, 1400], [0, 2000, 0, 1000], [0, 2000, 1, 0], [0, 2000, 1, 1000],
            [0, 2000, 1, 2000], [0, 2200, 0, 1200], [0, 2200, 2, 400], [0,
            2200, 2, 1800], [0, 2200, 3, 1200], [0, 2200, 3, 2000], [0, 2200,
            4, 200], [0, 2200, 4, 1400], [0, 2200, 4, 1600], [0, 2200, 4,
            2400], [0, 2200, 4, 2600], [0, 2400, 0, 1400], [0, 2400, 2, 0], [0,
            2400, 2, 1400], [0, 2400, 2, 2600], [0, 2600, 0, 1600], [0, 2600,
            3, 600], [0, 2600, 3, 2400], [0, 2800, 0, 0], [0, 2800, 0, 1800],
            [1, 200, 3, 400], [1, 200, 3, 1400], [1, 400, 2, 200], [1, 400, 2,
            1400], [1, 400, 2, 1600], [1, 400, 2, 2800], [1, 400, 3, 1200], [1,
            400, 4, 0], [1, 600, 2, 200], [1, 600, 2, 1600], [1, 600, 2, 2800],
            [1, 600, 3, 200], [1, 600, 3, 1200], [1, 600, 3, 2000], [1, 600, 4,
            0], [1, 600, 4, 200], [1, 600, 4, 1200], [1, 600, 4, 2400], [1,
            800, 3, 200], [1, 800, 4, 400], [1, 800, 4, 1600], [1, 800, 4,
            2800], [1, 1000, 1, 0], [1, 1000, 3, 400], [1, 1000, 3, 2200], [1,
            1200, 1, 200], [1, 1200, 3, 400], [1, 1200, 3, 1400], [1, 1200, 3,
            2200], [1, 1400, 1, 400], [1, 1400, 2, 200], [1, 1400, 2, 1400],
            [1, 1400, 2, 1600], [1, 1400, 2, 2800], [1, 1600, 1, 600], [1,
            1600, 2, 200], [1, 1600, 2, 1600], [1, 1600, 3, 200], [1, 1600, 3,
            1200], [1, 1600, 3, 2000], [1, 1600, 4, 0], [1, 1600, 4, 200], [1,
            1600, 4, 1200], [1, 1600, 4, 2400], [1, 1800, 1, 800], [1, 1800, 3,
            2000], [1, 1800, 4, 400], [1, 1800, 4, 1600], [1, 1800, 4, 2600],
            [1, 1800, 4, 2800], [1, 2000, 1, 0], [1, 2000, 1, 1000], [1, 2000,
            3, 2200], [1, 2200, 1, 200], [1, 2200, 1, 1000], [1, 2200, 1,
            1200], [1, 2200, 3, 400], [1, 2200, 3, 1400], [1, 2200, 3, 2200],
            [1, 2400, 1, 400], [1, 2400, 1, 1400], [1, 2400, 2, 200], [1, 2400,
            2, 1400], [1, 2400, 2, 1600], [1, 2400, 2, 2800], [1, 2600, 1,
            600], [1, 2600, 1, 1600], [1, 2600, 1, 1800], [1, 2600, 2, 1600],
            [1, 2600, 3, 200], [1, 2600, 3, 1200], [1, 2600, 3, 2000], [1,
            2600, 4, 0], [1, 2800, 1, 800], [1, 2800, 1, 1600], [1, 2800, 1,
            1800], [1, 2800, 2, 400], [1, 2800, 3, 200], [1, 2800, 3, 2000],
            [1, 2800, 4, 400], [1, 2800, 4, 1600], [1, 2800, 4, 2600], [1,
            2800, 4, 2800], [2, 0, 3, 0], [2, 0, 3, 1800], [2, 200, 4, 0], [2,
            200, 4, 200], [2, 200, 4, 1200], [2, 400, 3, 200], [2, 400, 3,
            1000], [2, 400, 3, 2000], [2, 400, 4, 200], [2, 400, 4, 1000], [2,
            400, 4, 1400], [2, 400, 4, 2600], [2, 600, 4, 1000], [2, 600, 4,
            2200], [2, 600, 4, 2400], [2, 1200, 3, 0], [2, 1200, 3, 1800], [2,
            1400, 2, 0], [2, 1600, 2, 200], [2, 1600, 3, 200], [2, 1600, 3,
            2000], [2, 1600, 4, 0], [2, 1600, 4, 1200], [2, 1600, 4, 2400], [2,
            1800, 2, 400], [2, 1800, 4, 800], [2, 1800, 4, 2000], [2, 1800, 4,
            2400], [2, 2000, 2, 600], [2, 2000, 4, 1000], [2, 2000, 4, 2200],
            [2, 2200, 2, 800], [2, 2400, 2, 1000], [2, 2600, 2, 0], [2, 2600,
            2, 1200], [2, 2600, 3, 0], [2, 2600, 3, 1800], [2, 2800, 2, 200],
            [2, 2800, 2, 1400], [2, 2800, 4, 0], [2, 2800, 4, 1200], [3, 200,
            4, 0], [3, 200, 4, 1200], [3, 200, 4, 2600], [3, 1000, 4, 1000],
            [3, 1000, 4, 1200], [3, 1000, 4, 2400], [3, 1000, 4, 2600], [3,
            1200, 4, 200], [3, 1200, 4, 1400], [3, 1200, 4, 2600], [3, 1800, 3,
            0], [3, 2000, 3, 200], [3, 2000, 4, 0], [3, 2000, 4, 1200], [3,
            2000, 4, 2600], [3, 2200, 3, 400], [3, 2400, 3, 600], [3, 2600, 3,
            800], [3, 2800, 3, 1000], [3, 2800, 4, 1000], [3, 2800, 4, 1200],
            [3, 2800, 4, 2400], [4, 1200, 4, 0], [4, 1400, 4, 200], [4, 1400,
            4, 400], [4, 1600, 4, 400], [4, 1800, 4, 600], [4, 2000, 4, 800],
            [4, 2200, 4, 1000], [4, 2400, 4, 0], [4, 2400, 4, 1200], [4, 2600,
            4, 200], [4, 2600, 4, 1400], [4, 2800, 4, 400], [4, 2800, 4,
            1600]],
        "false_keys": [[0, 0, 1, 0], [0, 1400, 3, 1800], [1, 800, 3, 200], [1,
            1000, 3, 400], [2, 200, 4, 200], [2, 400, 4, 1000], [3, 1000, 4,
            1000], [3, 2800, 4, 1000]],
        "loop_recall": 0.7064220183486238,
        "loop_precision": 0.967479674796748,
        "loop_precision_post_pcm": 0.972972972972973,
        "loops_unique": 246,
        "loops_found": 627,
        "loops_received": 2216,
        "revisit_opportunities": 218,
        "all_solved": True,
        "per_drone": [{'drone': 0, 'cost': 89.55062866210938,
            'relative_ate_cm': 3.456951450644659, 'vio_relative_ate_cm':
            6.902852534460312}, {'drone': 1, 'cost': 80.92842864990234,
            'relative_ate_cm': 3.4416330128255583, 'vio_relative_ate_cm':
            6.902852534460312}, {'drone': 2, 'cost': 65.9747314453125,
            'relative_ate_cm': 3.510796931266719, 'vio_relative_ate_cm':
            6.902852534460312}, {'drone': 3, 'cost': 80.84207916259766,
            'relative_ate_cm': 3.4286676548716866, 'vio_relative_ate_cm':
            6.902852534460312}, {'drone': 4, 'cost': 66.98129272460938,
            'relative_ate_cm': 3.4298269757080155, 'vio_relative_ate_cm':
            6.902852534460312}],
    },
    # the image demo at 10 drones x 30 frames (tools/demo_anchors.py
    # --drones 10)
    "image_d10": {
        "loop_keys": [[0, 0, 1, 0], [0, 0, 1, 200], [0, 0, 1, 1000], [0, 0, 1,
            1200], [0, 0, 1, 2000], [0, 0, 3, 400], [0, 0, 5, 400], [0, 0, 6,
            0], [0, 0, 6, 2000], [0, 0, 7, 2000], [0, 0, 8, 200], [0, 0, 8,
            1200], [0, 200, 1, 0], [0, 200, 1, 800], [0, 200, 1, 1000], [0,
            200, 1, 1800], [0, 200, 1, 2800], [0, 200, 4, 400], [0, 200, 4,
            1600], [0, 200, 4, 2800], [0, 200, 6, 200], [0, 200, 6, 400], [0,
            200, 6, 2400], [0, 400, 1, 400], [0, 400, 1, 600], [0, 400, 1,
            1400], [0, 400, 1, 1600], [0, 400, 1, 2600], [0, 400, 2, 0], [0,
            400, 2, 200], [0, 400, 2, 1600], [0, 400, 2, 2600], [0, 400, 2,
            2800], [0, 400, 3, 200], [0, 400, 3, 2000], [0, 400, 3, 2800], [0,
            400, 4, 0], [0, 400, 4, 1200], [0, 400, 4, 2400], [0, 400, 5, 0],
            [0, 400, 5, 1400], [0, 400, 6, 600], [0, 400, 6, 800], [0, 400, 6,
            2800], [0, 400, 8, 2800], [0, 400, 9, 200], [0, 400, 9, 1600], [0,
            600, 3, 1600], [0, 600, 5, 600], [0, 600, 5, 2200], [0, 600, 5,
            2400], [0, 600, 6, 1200], [0, 600, 9, 400], [0, 800, 1, 200], [0,
            800, 3, 1400], [0, 800, 6, 1600], [0, 800, 6, 1800], [0, 800, 8,
            200], [0, 1000, 0, 0], [0, 1000, 1, 0], [0, 1000, 1, 1000], [0,
            1000, 1, 1200], [0, 1000, 1, 2000], [0, 1000, 1, 2200], [0, 1000,
            3, 400], [0, 1000, 6, 0], [0, 1000, 6, 2000], [0, 1000, 6, 2200],
            [0, 1000, 7, 0], [0, 1000, 7, 1000], [0, 1000, 7, 2000], [0, 1000,
            8, 200], [0, 1000, 8, 1200], [0, 1000, 8, 2200], [0, 1200, 0,
            200], [0, 1200, 1, 800], [0, 1200, 1, 1000], [0, 1200, 1, 1800],
            [0, 1200, 1, 2800], [0, 1200, 2, 400], [0, 1200, 3, 200], [0,
            1200, 3, 2000], [0, 1200, 4, 400], [0, 1200, 4, 1400], [0, 1200,
            4, 1600], [0, 1200, 4, 2600], [0, 1200, 4, 2800], [0, 1200, 6,
            400], [0, 1200, 6, 2400], [0, 1200, 6, 2600], [0, 1200, 7, 400],
            [0, 1200, 7, 1400], [0, 1200, 8, 1800], [0, 1200, 8, 2800], [0,
            1200, 9, 0], [0, 1400, 0, 400], [0, 1400, 2, 0], [0, 1400, 2,
            1400], [0, 1400, 2, 2600], [0, 1400, 3, 0], [0, 1400, 3, 1800],
            [0, 1400, 5, 2800], [0, 1400, 6, 800], [0, 1400, 6, 1000], [0,
            1400, 6, 2800], [0, 1400, 9, 200], [0, 1400, 9, 600], [0, 1400, 9,
            2000], [0, 1400, 9, 2200], [0, 1600, 0, 600], [0, 1600, 5, 600],
            [0, 1600, 5, 800], [0, 1600, 6, 1200], [0, 1600, 6, 1400], [0,
            1800, 0, 800], [0, 1800, 1, 200], [0, 1800, 6, 1600], [0, 1800, 6,
            1800], [0, 1800, 8, 1200], [0, 2000, 0, 1000], [0, 2000, 1, 0],
            [0, 2000, 1, 1000], [0, 2000, 1, 2000], [0, 2000, 6, 0], [0, 2000,
            6, 200], [0, 2000, 6, 2000], [0, 2000, 6, 2200], [0, 2000, 7,
            2000], [0, 2000, 8, 1200], [0, 2200, 0, 1200], [0, 2200, 2, 400],
            [0, 2200, 3, 1200], [0, 2200, 3, 2000], [0, 2200, 4, 200], [0,
            2200, 4, 1400], [0, 2200, 4, 1600], [0, 2200, 4, 2400], [0, 2200,
            4, 2600], [0, 2200, 5, 0], [0, 2200, 5, 200], [0, 2200, 5, 1800],
            [0, 2200, 6, 400], [0, 2200, 6, 600], [0, 2200, 6, 2600], [0,
            2200, 7, 2200], [0, 2200, 8, 0], [0, 2200, 8, 2800], [0, 2200, 9,
            0], [0, 2200, 9, 1600], [0, 2200, 9, 1800], [0, 2400, 0, 1400],
            [0, 2400, 2, 0], [0, 2400, 2, 1400], [0, 2400, 2, 2600], [0, 2400,
            5, 1200], [0, 2400, 5, 2400], [0, 2400, 6, 800], [0, 2400, 6,
            1000], [0, 2400, 9, 400], [0, 2400, 9, 2200], [0, 2600, 0, 1600],
            [0, 2600, 3, 600], [0, 2600, 3, 2400], [0, 2600, 6, 1400], [0,
            2800, 0, 0], [0, 2800, 0, 1800], [0, 2800, 3, 1400], [0, 2800, 6,
            1800], [0, 2800, 6, 2000], [1, 0, 3, 400], [1, 0, 4, 400], [1, 0,
            5, 1800], [1, 0, 6, 0], [1, 0, 6, 400], [1, 0, 6, 2000], [1, 0, 6,
            2400], [1, 0, 7, 1000], [1, 0, 7, 2000], [1, 200, 3, 400], [1,
            200, 3, 1400], [1, 200, 5, 2200], [1, 200, 6, 0], [1, 200, 6,
            1600], [1, 200, 6, 2000], [1, 200, 7, 1000], [1, 200, 7, 1200],
            [1, 200, 8, 200], [1, 200, 8, 1000], [1, 200, 8, 1200], [1, 200,
            8, 2000], [1, 400, 2, 200], [1, 400, 2, 1400], [1, 400, 2, 1600],
            [1, 400, 2, 2800], [1, 400, 3, 1200], [1, 400, 4, 0], [1, 400, 5,
            600], [1, 400, 6, 600], [1, 400, 6, 800], [1, 400, 6, 2600], [1,
            400, 6, 2800], [1, 400, 7, 1200], [1, 400, 7, 2200], [1, 400, 8,
            0], [1, 400, 8, 1000], [1, 400, 9, 0], [1, 400, 9, 200], [1, 400,
            9, 400], [1, 400, 9, 2000], [1, 600, 2, 200], [1, 600, 2, 1600],
            [1, 600, 2, 2800], [1, 600, 3, 200], [1, 600, 3, 1200], [1, 600,
            3, 2000], [1, 600, 4, 0], [1, 600, 4, 200], [1, 600, 4, 1200], [1,
            600, 4, 2400], [1, 600, 5, 0], [1, 600, 5, 200], [1, 600, 5,
            1600], [1, 600, 5, 1800], [1, 600, 6, 400], [1, 600, 6, 600], [1,
            600, 6, 800], [1, 600, 6, 2800], [1, 600, 7, 400], [1, 600, 7,
            1400], [1, 600, 7, 2200], [1, 600, 8, 800], [1, 600, 8, 1800], [1,
            600, 8, 2800], [1, 600, 9, 200], [1, 600, 9, 1600], [1, 800, 4,
            400], [1, 800, 4, 1600], [1, 800, 4, 2800], [1, 800, 6, 400], [1,
            800, 6, 2400], [1, 800, 7, 400], [1, 800, 7, 1400], [1, 800, 7,
            2400], [1, 800, 8, 800], [1, 800, 8, 1800], [1, 800, 8, 2600], [1,
            1000, 1, 0], [1, 1000, 3, 400], [1, 1000, 3, 2200], [1, 1000, 5,
            1800], [1, 1000, 6, 0], [1, 1000, 6, 2000], [1, 1000, 6, 2400],
            [1, 1000, 7, 1000], [1, 1000, 7, 2000], [1, 1200, 1, 200], [1,
            1200, 3, 400], [1, 1200, 3, 1400], [1, 1200, 3, 2200], [1, 1200,
            6, 0], [1, 1200, 6, 200], [1, 1200, 6, 1600], [1, 1200, 6, 2000],
            [1, 1200, 6, 2200], [1, 1200, 7, 1000], [1, 1200, 7, 1200], [1,
            1200, 7, 2000], [1, 1200, 7, 2200], [1, 1200, 8, 200], [1, 1200,
            8, 1000], [1, 1200, 8, 1200], [1, 1200, 8, 2000], [1, 1400, 1,
            400], [1, 1400, 2, 200], [1, 1400, 2, 1400], [1, 1400, 2, 1600],
            [1, 1400, 2, 2800], [1, 1400, 5, 600], [1, 1400, 6, 600], [1,
            1400, 6, 800], [1, 1400, 6, 2800], [1, 1400, 7, 200], [1, 1400, 7,
            2200], [1, 1400, 8, 0], [1, 1400, 8, 1000], [1, 1400, 9, 200], [1,
            1400, 9, 400], [1, 1400, 9, 2000], [1, 1600, 1, 600], [1, 1600, 2,
            200], [1, 1600, 2, 1600], [1, 1600, 3, 200], [1, 1600, 3, 2000],
            [1, 1600, 4, 0], [1, 1600, 4, 200], [1, 1600, 4, 1200], [1, 1600,
            4, 2400], [1, 1600, 5, 0], [1, 1600, 5, 200], [1, 1600, 5, 1600],
            [1, 1600, 5, 1800], [1, 1600, 6, 400], [1, 1600, 6, 600], [1,
            1600, 6, 800], [1, 1600, 6, 2800], [1, 1600, 7, 400], [1, 1600, 7,
            1400], [1, 1600, 7, 2200], [1, 1600, 7, 2400], [1, 1600, 8, 800],
            [1, 1600, 8, 1800], [1, 1600, 8, 2800], [1, 1600, 9, 1600], [1,
            1800, 1, 800], [1, 1800, 2, 400], [1, 1800, 3, 2000], [1, 1800, 4,
            1600], [1, 1800, 4, 2800], [1, 1800, 6, 400], [1, 1800, 6, 2400],
            [1, 1800, 6, 2600], [1, 1800, 7, 400], [1, 1800, 7, 1400], [1,
            1800, 7, 2400], [1, 1800, 8, 800], [1, 1800, 8, 1800], [1, 1800,
            8, 2600], [1, 1800, 9, 0], [1, 2000, 1, 0], [1, 2000, 1, 1000],
            [1, 2000, 6, 0], [1, 2000, 6, 2000], [1, 2000, 7, 1000], [1, 2000,
            7, 2000], [1, 2000, 7, 2800], [1, 2200, 1, 200], [1, 2200, 1,
            1200], [1, 2200, 3, 400], [1, 2200, 3, 1400], [1, 2200, 3, 2200],
            [1, 2200, 5, 1800], [1, 2200, 6, 0], [1, 2200, 6, 2200], [1, 2200,
            7, 1000], [1, 2200, 7, 1200], [1, 2200, 7, 2000], [1, 2200, 7,
            2200], [1, 2200, 8, 0], [1, 2200, 8, 200], [1, 2200, 8, 1000], [1,
            2200, 8, 1200], [1, 2200, 8, 2000], [1, 2400, 1, 400], [1, 2400,
            1, 1400], [1, 2400, 2, 200], [1, 2400, 2, 1400], [1, 2400, 2,
            1600], [1, 2400, 2, 2800], [1, 2400, 5, 600], [1, 2400, 6, 600],
            [1, 2400, 6, 800], [1, 2400, 6, 2800], [1, 2400, 7, 200], [1,
            2400, 7, 2200], [1, 2400, 8, 0], [1, 2400, 8, 1000], [1, 2400, 8,
            2000], [1, 2400, 9, 200], [1, 2400, 9, 400], [1, 2400, 9, 2000],
            [1, 2600, 1, 600], [1, 2600, 1, 1600], [1, 2600, 2, 1600], [1,
            2600, 2, 1800], [1, 2600, 3, 200], [1, 2600, 3, 1200], [1, 2600,
            3, 2000], [1, 2600, 4, 0], [1, 2600, 4, 200], [1, 2600, 4, 1200],
            [1, 2600, 4, 2400], [1, 2600, 5, 0], [1, 2600, 5, 200], [1, 2600,
            5, 1600], [1, 2600, 5, 1800], [1, 2600, 6, 400], [1, 2600, 6,
            600], [1, 2600, 6, 2800], [1, 2600, 7, 400], [1, 2600, 7, 1400],
            [1, 2600, 7, 2400], [1, 2600, 8, 800], [1, 2600, 8, 1800], [1,
            2600, 8, 2800], [1, 2600, 9, 1600], [1, 2800, 1, 800], [1, 2800,
            1, 1800], [1, 2800, 2, 400], [1, 2800, 3, 2000], [1, 2800, 4,
            400], [1, 2800, 4, 1600], [1, 2800, 4, 2600], [1, 2800, 4, 2800],
            [1, 2800, 6, 400], [1, 2800, 6, 2400], [1, 2800, 6, 2600], [1,
            2800, 7, 400], [1, 2800, 7, 1400], [1, 2800, 7, 2400], [1, 2800,
            8, 800], [1, 2800, 8, 1600], [1, 2800, 8, 1800], [1, 2800, 8,
            2800], [1, 2800, 9, 0], [2, 0, 3, 0], [2, 0, 3, 1800], [2, 0, 5,
            1200], [2, 0, 5, 2800], [2, 0, 6, 800], [2, 0, 9, 400], [2, 0, 9,
            600], [2, 0, 9, 2200], [2, 0, 9, 2400], [2, 200, 4, 0], [2, 200,
            4, 200], [2, 200, 4, 1200], [2, 200, 6, 600], [2, 200, 6, 800],
            [2, 200, 6, 2800], [2, 200, 8, 0], [2, 200, 9, 200], [2, 200, 9,
            400], [2, 200, 9, 2000], [2, 400, 3, 200], [2, 400, 3, 1000], [2,
            400, 3, 2000], [2, 400, 3, 2800], [2, 400, 4, 200], [2, 400, 4,
            1400], [2, 400, 4, 2600], [2, 400, 5, 0], [2, 400, 5, 200], [2,
            400, 5, 1600], [2, 400, 6, 600], [2, 400, 6, 2400], [2, 400, 7,
            400], [2, 400, 8, 2800], [2, 400, 9, 0], [2, 400, 9, 1400], [2,
            400, 9, 1800], [2, 600, 3, 200], [2, 600, 4, 200], [2, 600, 4,
            1000], [2, 600, 4, 2200], [2, 600, 4, 2400], [2, 600, 5, 0], [2,
            600, 5, 1600], [2, 600, 7, 400], [2, 600, 7, 1400], [2, 600, 7,
            2400], [2, 600, 8, 800], [2, 600, 9, 1400], [2, 600, 9, 1600], [2,
            800, 9, 1200], [2, 800, 9, 2800], [2, 1000, 5, 1200], [2, 1000, 9,
            1000], [2, 1000, 9, 2600], [2, 1000, 9, 2800], [2, 1200, 3, 0],
            [2, 1200, 3, 1800], [2, 1200, 5, 1200], [2, 1200, 9, 600], [2,
            1200, 9, 800], [2, 1200, 9, 1200], [2, 1200, 9, 2400], [2, 1400,
            2, 0], [2, 1400, 5, 1200], [2, 1400, 5, 1400], [2, 1400, 6, 1000],
            [2, 1400, 9, 400], [2, 1400, 9, 2200], [2, 1600, 2, 200], [2,
            1600, 3, 200], [2, 1600, 3, 2000], [2, 1600, 4, 0], [2, 1600, 4,
            1200], [2, 1600, 4, 2400], [2, 1600, 5, 0], [2, 1600, 5, 1600],
            [2, 1600, 6, 400], [2, 1600, 6, 800], [2, 1600, 6, 2800], [2,
            1600, 7, 1200], [2, 1600, 7, 2200], [2, 1600, 8, 1000], [2, 1600,
            8, 1800], [2, 1600, 8, 2800], [2, 1600, 9, 200], [2, 1600, 9,
            1600], [2, 1600, 9, 1800], [2, 1600, 9, 2000], [2, 1800, 2, 400],
            [2, 1800, 3, 1000], [2, 1800, 4, 800], [2, 1800, 4, 1200], [2,
            1800, 4, 2000], [2, 1800, 4, 2400], [2, 1800, 7, 2400], [2, 1800,
            8, 800], [2, 1800, 9, 1600], [2, 2000, 2, 600], [2, 2000, 4,
            1000], [2, 2000, 4, 2000], [2, 2000, 4, 2200], [2, 2000, 9, 1400],
            [2, 2200, 2, 800], [2, 2200, 9, 1000], [2, 2200, 9, 1200], [2,
            2200, 9, 2800], [2, 2400, 2, 1000], [2, 2400, 5, 1000], [2, 2400,
            5, 1200], [2, 2400, 9, 800], [2, 2400, 9, 1200], [2, 2400, 9,
            2600], [2, 2600, 2, 0], [2, 2600, 2, 1200], [2, 2600, 3, 0], [2,
            2600, 3, 1800], [2, 2600, 5, 1200], [2, 2600, 5, 2800], [2, 2600,
            9, 600], [2, 2600, 9, 2200], [2, 2600, 9, 2400], [2, 2800, 2,
            200], [2, 2800, 2, 1400], [2, 2800, 4, 0], [2, 2800, 4, 1200], [2,
            2800, 6, 600], [2, 2800, 6, 2800], [2, 2800, 9, 200], [2, 2800, 9,
            400], [2, 2800, 9, 2000], [2, 2800, 9, 2200], [3, 0, 5, 1200], [3,
            0, 5, 1600], [3, 0, 5, 2800], [3, 0, 9, 600], [3, 0, 9, 2400], [3,
            200, 4, 0], [3, 200, 4, 1200], [3, 200, 4, 2600], [3, 200, 5, 0],
            [3, 200, 5, 1600], [3, 200, 6, 400], [3, 200, 6, 2800], [3, 200,
            7, 400], [3, 200, 7, 1400], [3, 200, 7, 2400], [3, 200, 8, 800],
            [3, 200, 8, 1000], [3, 200, 8, 1800], [3, 200, 8, 2800], [3, 200,
            9, 0], [3, 200, 9, 1800], [3, 400, 5, 400], [3, 400, 5, 2000], [3,
            400, 6, 0], [3, 400, 6, 2000], [3, 400, 8, 200], [3, 400, 8,
            1200], [3, 600, 5, 600], [3, 600, 5, 800], [3, 600, 5, 2200], [3,
            600, 5, 2400], [3, 600, 6, 1400], [3, 800, 5, 1000], [3, 800, 5,
            2600], [3, 800, 9, 400], [3, 800, 9, 2200], [3, 1000, 4, 1200],
            [3, 1000, 4, 2400], [3, 1000, 4, 2600], [3, 1000, 5, 1400], [3,
            1000, 9, 0], [3, 1000, 9, 1600], [3, 1000, 9, 1800], [3, 1200, 4,
            200], [3, 1200, 4, 1400], [3, 1200, 4, 2600], [3, 1200, 5, 200],
            [3, 1200, 5, 1800], [3, 1200, 6, 600], [3, 1200, 6, 2600], [3,
            1200, 7, 200], [3, 1200, 7, 1200], [3, 1200, 7, 1400], [3, 1200,
            7, 2200], [3, 1200, 8, 0], [3, 1200, 8, 1000], [3, 1200, 8, 1800],
            [3, 1200, 9, 0], [3, 1400, 5, 600], [3, 1400, 5, 2200], [3, 1400,
            8, 1000], [3, 1400, 8, 2000], [3, 1600, 5, 800], [3, 1800, 3, 0],
            [3, 1800, 5, 1200], [3, 1800, 5, 2800], [3, 1800, 9, 600], [3,
            2000, 3, 200], [3, 2000, 4, 0], [3, 2000, 4, 1200], [3, 2000, 4,
            2600], [3, 2000, 5, 0], [3, 2000, 5, 1600], [3, 2000, 6, 400], [3,
            2000, 6, 2600], [3, 2000, 6, 2800], [3, 2000, 7, 400], [3, 2000,
            7, 1400], [3, 2000, 7, 2400], [3, 2000, 8, 800], [3, 2000, 8,
            1800], [3, 2000, 8, 2800], [3, 2000, 9, 0], [3, 2000, 9, 1800],
            [3, 2200, 3, 400], [3, 2200, 4, 1400], [3, 2200, 5, 400], [3,
            2200, 5, 2000], [3, 2200, 6, 0], [3, 2200, 6, 2000], [3, 2200, 8,
            0], [3, 2400, 3, 600], [3, 2400, 5, 600], [3, 2400, 5, 800], [3,
            2400, 5, 2200], [3, 2400, 6, 1400], [3, 2600, 3, 800], [3, 2600,
            5, 1000], [3, 2600, 5, 2600], [3, 2600, 9, 2200], [3, 2800, 3,
            1000], [3, 2800, 4, 1200], [3, 2800, 4, 2400], [3, 2800, 5, 1400],
            [3, 2800, 9, 1600], [4, 0, 5, 0], [4, 0, 5, 200], [4, 0, 5, 1600],
            [4, 0, 6, 400], [4, 0, 6, 800], [4, 0, 6, 2800], [4, 0, 7, 400],
            [4, 0, 7, 1400], [4, 0, 7, 2400], [4, 0, 8, 800], [4, 0, 8, 1800],
            [4, 0, 9, 200], [4, 0, 9, 1600], [4, 0, 9, 1800], [4, 200, 5,
            200], [4, 200, 6, 600], [4, 200, 6, 2600], [4, 200, 7, 2400], [4,
            200, 8, 800], [4, 200, 9, 0], [4, 200, 9, 1600], [4, 400, 6,
            2400], [4, 400, 7, 600], [4, 400, 7, 1600], [4, 400, 8, 600], [4,
            400, 8, 1600], [4, 400, 8, 2600], [4, 600, 7, 2600], [4, 1000, 5,
            1600], [4, 1000, 9, 1400], [4, 1200, 4, 0], [4, 1200, 5, 0], [4,
            1200, 5, 1400], [4, 1200, 5, 1600], [4, 1200, 6, 600], [4, 1200,
            6, 2800], [4, 1200, 7, 1400], [4, 1200, 8, 1800], [4, 1200, 9,
            1400], [4, 1200, 9, 1600], [4, 1400, 4, 200], [4, 1400, 4, 400],
            [4, 1400, 5, 0], [4, 1400, 5, 200], [4, 1400, 5, 1800], [4, 1400,
            6, 600], [4, 1400, 6, 2600], [4, 1400, 7, 1200], [4, 1400, 7,
            2200], [4, 1400, 8, 0], [4, 1400, 9, 0], [4, 1400, 9, 1800], [4,
            1600, 4, 400], [4, 1600, 7, 400], [4, 1600, 7, 600], [4, 1600, 7,
            1400], [4, 1600, 7, 2400], [4, 1600, 8, 800], [4, 1600, 8, 1600],
            [4, 1600, 8, 1800], [4, 1600, 8, 2600], [4, 1800, 4, 600], [4,
            2000, 4, 800], [4, 2000, 4, 1000], [4, 2000, 7, 600], [4, 2200, 4,
            1000], [4, 2200, 7, 400], [4, 2200, 9, 1400], [4, 2400, 4, 0], [4,
            2400, 4, 1200], [4, 2400, 5, 1400], [4, 2400, 6, 600], [4, 2400,
            7, 1400], [4, 2400, 7, 2400], [4, 2400, 8, 800], [4, 2400, 8,
            1800], [4, 2400, 9, 0], [4, 2400, 9, 1600], [4, 2600, 4, 200], [4,
            2600, 4, 1400], [4, 2600, 5, 0], [4, 2600, 5, 200], [4, 2600, 5,
            1600], [4, 2600, 5, 1800], [4, 2600, 6, 400], [4, 2600, 6, 600],
            [4, 2600, 6, 2400], [4, 2600, 6, 2600], [4, 2600, 7, 400], [4,
            2600, 8, 0], [4, 2600, 9, 0], [4, 2600, 9, 1800], [4, 2800, 4,
            400], [4, 2800, 4, 1600], [4, 2800, 6, 2400], [4, 2800, 7, 600],
            [4, 2800, 7, 1400], [4, 2800, 7, 2400], [4, 2800, 8, 800], [4,
            2800, 8, 1600], [4, 2800, 8, 2600], [5, 0, 6, 2600], [5, 0, 7,
            400], [5, 0, 7, 1400], [5, 0, 7, 2400], [5, 0, 8, 800], [5, 0, 8,
            1800], [5, 0, 8, 2800], [5, 0, 9, 0], [5, 0, 9, 1800], [5, 200, 6,
            600], [5, 200, 6, 2600], [5, 200, 7, 1200], [5, 200, 7, 1400], [5,
            200, 7, 2200], [5, 200, 7, 2400], [5, 200, 8, 0], [5, 200, 8,
            800], [5, 200, 9, 0], [5, 400, 6, 2000], [5, 400, 7, 200], [5,
            400, 8, 2000], [5, 600, 6, 1200], [5, 600, 8, 2000], [5, 600, 9,
            2000], [5, 800, 6, 1000], [5, 1000, 9, 400], [5, 1000, 9, 800],
            [5, 1000, 9, 2200], [5, 1000, 9, 2400], [5, 1200, 9, 600], [5,
            1200, 9, 1000], [5, 1200, 9, 2200], [5, 1200, 9, 2400], [5, 1200,
            9, 2600], [5, 1200, 9, 2800], [5, 1400, 9, 1600], [5, 1600, 5, 0],
            [5, 1600, 7, 400], [5, 1600, 7, 1400], [5, 1600, 7, 2400], [5,
            1600, 8, 800], [5, 1600, 8, 1800], [5, 1600, 8, 2800], [5, 1600,
            9, 0], [5, 1600, 9, 1400], [5, 1800, 5, 200], [5, 1800, 6, 200],
            [5, 1800, 6, 600], [5, 1800, 6, 2600], [5, 1800, 7, 200], [5,
            1800, 7, 1200], [5, 1800, 7, 2200], [5, 1800, 8, 0], [5, 1800, 8,
            1000], [5, 1800, 9, 0], [5, 1800, 9, 1800], [5, 2000, 5, 400], [5,
            2000, 8, 2000], [5, 2000, 9, 2000], [5, 2200, 5, 600], [5, 2200,
            6, 1200], [5, 2400, 5, 800], [5, 2400, 6, 1000], [5, 2400, 9,
            600], [5, 2400, 9, 2200], [5, 2600, 5, 1000], [5, 2600, 9, 400],
            [5, 2600, 9, 2200], [5, 2600, 9, 2400], [5, 2600, 9, 2600], [5,
            2800, 5, 1200], [5, 2800, 9, 600], [5, 2800, 9, 2200], [5, 2800,
            9, 2400], [6, 0, 7, 0], [6, 0, 7, 1000], [6, 0, 7, 2000], [6, 0,
            8, 200], [6, 0, 8, 1200], [6, 0, 8, 2200], [6, 200, 7, 0], [6,
            200, 7, 200], [6, 200, 7, 1000], [6, 200, 7, 1200], [6, 200, 7,
            2000], [6, 200, 7, 2200], [6, 400, 8, 1800], [6, 400, 8, 2800],
            [6, 400, 9, 0], [6, 400, 9, 1800], [6, 600, 7, 1200], [6, 600, 7,
            2200], [6, 600, 8, 0], [6, 600, 9, 0], [6, 600, 9, 1600], [6, 600,
            9, 1800], [6, 800, 8, 1000], [6, 800, 8, 2800], [6, 800, 9, 200],
            [6, 800, 9, 1800], [6, 1000, 9, 400], [6, 1000, 9, 2200], [6,
            1200, 8, 2000], [6, 1600, 8, 200], [6, 2000, 6, 0], [6, 2000, 7,
            1000], [6, 2000, 7, 2000], [6, 2000, 8, 200], [6, 2000, 8, 1200],
            [6, 2200, 6, 0], [6, 2200, 6, 200], [6, 2200, 7, 0], [6, 2200, 7,
            1000], [6, 2200, 7, 1200], [6, 2200, 7, 2000], [6, 2200, 8, 200],
            [6, 2200, 8, 1200], [6, 2200, 8, 2200], [6, 2400, 6, 200], [6,
            2400, 6, 400], [6, 2400, 7, 1200], [6, 2400, 7, 2200], [6, 2400,
            8, 1800], [6, 2400, 8, 2800], [6, 2600, 6, 400], [6, 2600, 6,
            600], [6, 2600, 7, 2200], [6, 2600, 8, 0], [6, 2600, 8, 1000], [6,
            2600, 8, 2800], [6, 2600, 9, 0], [6, 2600, 9, 1600], [6, 2600, 9,
            1800], [6, 2800, 6, 600], [6, 2800, 6, 800], [6, 2800, 7, 2200],
            [6, 2800, 8, 0], [6, 2800, 8, 2800], [6, 2800, 9, 200], [6, 2800,
            9, 1600], [6, 2800, 9, 2000], [7, 0, 8, 200], [7, 0, 8, 1200], [7,
            0, 8, 2200], [7, 0, 8, 2400], [7, 200, 8, 0], [7, 200, 8, 1000],
            [7, 200, 8, 2000], [7, 400, 8, 800], [7, 400, 8, 1800], [7, 400,
            8, 2800], [7, 400, 9, 0], [7, 400, 9, 1800], [7, 600, 8, 600], [7,
            600, 8, 1600], [7, 600, 8, 2600], [7, 800, 8, 400], [7, 800, 8,
            1400], [7, 800, 8, 2400], [7, 1000, 7, 0], [7, 1000, 8, 200], [7,
            1000, 8, 1200], [7, 1000, 8, 1400], [7, 1000, 8, 2200], [7, 1200,
            7, 200], [7, 1200, 8, 0], [7, 1200, 8, 1000], [7, 1200, 8, 2000],
            [7, 1200, 8, 2800], [7, 1400, 7, 400], [7, 1400, 8, 800], [7,
            1400, 8, 1800], [7, 1400, 8, 2800], [7, 1400, 9, 1600], [7, 1400,
            9, 1800], [7, 1600, 7, 600], [7, 1600, 8, 600], [7, 1600, 8,
            1600], [7, 1600, 8, 2600], [7, 1800, 7, 800], [7, 1800, 8, 400],
            [7, 1800, 8, 600], [7, 1800, 8, 1400], [7, 1800, 8, 2400], [7,
            2000, 7, 0], [7, 2000, 7, 1000], [7, 2000, 8, 200], [7, 2000, 8,
            1200], [7, 2000, 8, 2200], [7, 2200, 7, 200], [7, 2200, 7, 1200],
            [7, 2200, 8, 0], [7, 2200, 8, 1000], [7, 2200, 8, 2000], [7, 2200,
            9, 200], [7, 2200, 9, 2000], [7, 2400, 7, 400], [7, 2400, 7,
            1400], [7, 2400, 8, 800], [7, 2400, 8, 1800], [7, 2400, 8, 2800],
            [7, 2400, 9, 1600], [7, 2600, 7, 600], [7, 2600, 7, 1600], [7,
            2600, 8, 600], [7, 2600, 8, 1600], [7, 2600, 8, 2600], [7, 2800,
            7, 800], [7, 2800, 7, 1800], [7, 2800, 8, 400], [7, 2800, 8,
            1400], [7, 2800, 8, 2400], [8, 0, 9, 0], [8, 0, 9, 1800], [8, 0,
            9, 2000], [8, 800, 9, 1600], [8, 1000, 8, 0], [8, 1000, 9, 200],
            [8, 1000, 9, 2000], [8, 1200, 8, 200], [8, 1400, 8, 400], [8,
            1600, 8, 600], [8, 1800, 8, 800], [8, 1800, 9, 1800], [8, 2000, 8,
            0], [8, 2000, 8, 1000], [8, 2000, 9, 2000], [8, 2200, 8, 200], [8,
            2200, 8, 1200], [8, 2400, 8, 400], [8, 2400, 8, 1400], [8, 2600,
            8, 600], [8, 2600, 8, 1600], [8, 2800, 9, 0], [8, 2800, 9, 200],
            [8, 2800, 9, 1800], [9, 1600, 9, 0], [9, 1800, 9, 0], [9, 1800, 9,
            200], [9, 2000, 9, 200], [9, 2000, 9, 400], [9, 2200, 9, 400], [9,
            2200, 9, 600], [9, 2400, 9, 600], [9, 2600, 9, 800], [9, 2600, 9,
            1000], [9, 2800, 9, 1000]],
        "false_keys": [[0, 0, 1, 0], [0, 0, 5, 400], [0, 600, 5, 2200], [0,
            1200, 1, 1000], [0, 1800, 8, 1200], [0, 2000, 8, 1200], [0, 2800,
            3, 1400], [1, 0, 3, 400], [1, 0, 4, 400], [1, 200, 5, 2200], [1,
            1200, 6, 1600], [1, 1800, 2, 400], [1, 2000, 7, 2800], [1, 2800,
            8, 1600], [2, 200, 4, 200], [2, 400, 3, 2800], [2, 400, 6, 2400],
            [2, 400, 9, 1400], [2, 600, 3, 200], [2, 600, 4, 200], [2, 600, 8,
            800], [2, 800, 9, 2800], [2, 1000, 5, 1200], [2, 1000, 9, 2600],
            [2, 1200, 9, 1200], [2, 1400, 5, 1200], [2, 1800, 4, 2000], [2,
            2000, 4, 2000], [2, 2200, 9, 1000], [2, 2400, 5, 1000], [2, 2400,
            9, 1200], [3, 0, 5, 1600], [3, 200, 8, 1000], [3, 600, 5, 2400],
            [3, 800, 9, 400], [3, 1200, 7, 1400], [3, 2200, 4, 1400], [4, 400,
            6, 2400], [4, 600, 7, 2600], [4, 2000, 7, 600], [4, 2200, 7, 400],
            [4, 2800, 7, 1400], [5, 1000, 9, 800], [5, 1200, 9, 2800], [5,
            2400, 9, 600], [5, 2600, 9, 400], [5, 2600, 9, 2600], [5, 2800, 9,
            2200], [6, 1200, 8, 2000], [6, 1600, 8, 200], [7, 800, 8, 400],
            [7, 1000, 8, 1400]],
        "loop_recall": 0.7093596059113301,
        "loop_precision": 0.9478957915831663,
        "loop_precision_post_pcm": 0.9731934731934732,
        "loops_unique": 998,
        "loops_found": 2272,
        "loops_received": 17626,
        "revisit_opportunities": 812,
        "all_solved": True,
        "per_drone": [{'drone': 0, 'cost': 479.31512451171875,
            'relative_ate_cm': 3.2076921131364995, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 1, 'cost': 496.441650390625,
            'relative_ate_cm': 3.2123100467906514, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 2, 'cost': 446.6573486328125,
            'relative_ate_cm': 3.1653420952733478, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 3, 'cost': 472.6708068847656,
            'relative_ate_cm': 3.2652052171611845, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 4, 'cost': 423.3739013671875,
            'relative_ate_cm': 3.1794770837973356, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 5, 'cost': 455.67510986328125,
            'relative_ate_cm': 3.283242696917859, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 6, 'cost': 393.87408447265625,
            'relative_ate_cm': 3.4309503834046366, 'vio_relative_ate_cm':
            10.317075151792594}, {'drone': 7, 'cost': 444.5181579589844,
            'relative_ate_cm': 3.3047239167234856, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 8, 'cost': 472.5784912109375,
            'relative_ate_cm': 3.249397382914522, 'vio_relative_ate_cm':
            10.348307875745217}, {'drone': 9, 'cost': 395.95391845703125,
            'relative_ate_cm': 3.229877092064849, 'vio_relative_ate_cm':
            10.401018167455769}],
    },
}
DEMO_KEY_SHARE = 0.02       # feature demo: symmetric key difference / count
DEMO_COST_RTOL = 0.01       # feature demo: per-drone final cost
DEMO_ATE_ATOL_CM = 0.5      # feature demo: relative ATE against its anchor
IMG_RECALL_ATOL = 0.03      # image demo: recall against its anchor
IMG_PRECISION_DROP = 0.02   # image demo: precision >= anchor - 0.02
IMG_PCM_PRECISION_DROP = 0.01
IMG_ATE_SLACK_CM = 0.5      # image demo: relative ATE <= anchor + 0.5 cm
IMG_KEY_SHARE = 0.2         # image demo: symmetric key difference / count
#                             (20-37 of 246 over six draw streams:
#                             tools/demo_draw_spread.py)
# detector parity, card against CPU on the same draws: retrieval and the
# (homography-filtered) matches equal on every lane; PnP inlier sets may
# differ on a few lanes (a point at the angular gate rounds either way, and
# a count one off can change which near-tied hypothesis wins)
DET_LANE_SHARE = 0.03       # live lanes whose PnP inlier sets differ
DET_INLIER_SLACK = 2        # an accepted loop's inlier count
DET_DPOSE_ATOL = 0.02       # an accepted loop's dpose (m, rad)


# The multi-device phase's anchors, from the JAX package on the CPU on a
# virtual 8-device mesh (PYTHONPATH=. JAX_PLATFORMS=cpu python
# tools/parallel_anchors.py): the frame-sharded window on the dryrun's
# problem at 4 and 1 devices, the fleet lanes' costs (lm_solve_multigraph)
# and the exact lm_solve_bt at F=1024, 50 iterations.
PARALLEL_ANCHORS = {
    "window_256": {"world_4": 371.3642578125, "world_1": 371.3642578125,
                   "loops": 80},
    "fleet_100": {"cost": [181.0632781982422, 177.56858825683594,
                           181.82156372070312, 182.10226440429688,
                           175.84750366210938, 198.81910705566406,
                           198.2699737548828, 196.14791870117188],
                  "loop_capacity": 98, "iterations": 20},
    "exact_1024": {"cost": 1998.881591796875, "initial_cost": 35108.265625,
                   "loops": 1022},
}
LAYOUT_BAR = 5e-3           # __graft_entry__.py:93, :114, :147
LAYOUT_RUNS = ((1, "nccl"), (4, "gloo"))
# The production node's phase (11a)
NODE_DRONES = 5
NODE_FPS = 8.0              # frames a wall second fed to the free node
NODE_FINAL_SHARE = 0.85     # tests/test_run_node.py:168-170
NODE_MIN_SOLVED = 3
NODE_MP_ATE = 0.3           # tests/test_multiprocess.py:52
NODE_MP_PORT = 17801
REPORT_ATE_RTOL = 1e-9      # a report's ATE against the demo's
WORK_DIR = "build/chip_smoke"   # scratch files, inside the checkout
# The training phase (12a): anchors from the JAX package on the CPU
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tools/train_anchors.py)
TRAIN_ANCHORS = {'superpoint': {'detection': {'precision': 0.7677165354330708,
                              'recall': 0.8369098712446352,
                              'tp': 195,
                              'fp': 59,
                              'fn': 38},
                'matching': {'textured': {'match_precision': 0.8805555555555555,
                                          'matches': 360,
                                          'correct': 317},
                             'flat': {'match_precision': 0.8876712328767123,
                                      'matches': 365,
                                      'correct': 324},
                             'easy': {'match_precision': 0.921832884097035,
                                      'matches': 371,
                                      'correct': 342}},
                'detector_losses': [[0, 0.252052366733551],
                                    [1, 0.1726822406053543],
                                    [2, 0.34399306774139404],
                                    [3, 0.15973849594593048],
                                    [4, 0.22343170642852783],
                                    [5, 0.29402250051498413],
                                    [6, 0.4085695743560791],
                                    [7, 0.2676301598548889],
                                    [8, 0.23711085319519043],
                                    [9, 0.2784562110900879],
                                    [10, 0.3001287579536438],
                                    [11, 0.2812025249004364],
                                    [12, 0.22704750299453735],
                                    [13, 0.380655974149704],
                                    [14, 0.27042752504348755],
                                    [15, 0.2795419991016388],
                                    [16, 0.39351189136505127],
                                    [17, 0.3841511309146881],
                                    [18, 0.3065623342990875],
                                    [19, 0.38080939650535583]],
                'joint_losses': [[0,
                                  0.5085117816925049,
                                  0.25645941495895386,
                                  0.252052366733551],
                                 [1,
                                  0.8174649477005005,
                                  0.29654350876808167,
                                  0.5209214091300964],
                                 [2,
                                  0.5322881937026978,
                                  0.28127405047416687,
                                  0.2510141432285309],
                                 [3,
                                  0.6417014598846436,
                                  0.30574363470077515,
                                  0.335957795381546],
                                 [4,
                                  0.7613773345947266,
                                  0.4623754918575287,
                                  0.29900187253952026],
                                 [5,
                                  0.9201656579971313,
                                  0.33358752727508545,
                                  0.5865781307220459],
                                 [6,
                                  0.8749579191207886,
                                  0.47707679867744446,
                                  0.39788109064102173],
                                 [7,
                                  0.6602506041526794,
                                  0.37578216195106506,
                                  0.2844684422016144],
                                 [8,
                                  0.7802667617797852,
                                  0.3309856653213501,
                                  0.44928112626075745],
                                 [9,
                                  0.8457125425338745,
                                  0.3106546700000763,
                                  0.5350579023361206],
                                 [10,
                                  0.8745291829109192,
                                  0.41136306524276733,
                                  0.46316611766815186],
                                 [11,
                                  1.0992143154144287,
                                  0.40352627635002136,
                                  0.695688009262085],
                                 [12,
                                  0.6113481521606445,
                                  0.33891761302948,
                                  0.27243050932884216],
                                 [13,
                                  0.634278416633606,
                                  0.3042115867137909,
                                  0.33006682991981506],
                                 [14,
                                  0.7209631204605103,
                                  0.3830224275588989,
                                  0.3379407227039337],
                                 [15,
                                  0.694089412689209,
                                  0.27650731801986694,
                                  0.41758209466934204],
                                 [16,
                                  0.5145219564437866,
                                  0.2539141774177551,
                                  0.2606078088283539],
                                 [17,
                                  0.5944993495941162,
                                  0.29443103075027466,
                                  0.30006828904151917],
                                 [18,
                                  0.7246479988098145,
                                  0.37853842973709106,
                                  0.3461095988750458],
                                 [19,
                                  0.8820382952690125,
                                  0.344482421875,
                                  0.5375558733940125]]},
 'netvlad': {'hard_revisit_96': {'recall_at_1': 0.78125,
                                 'mean_margin': 0.13215492262194553,
                                 'mean_pos_sim': 0.5607724189758301,
                                 'mean_top_neg_sim': 0.42861748362580937,
                                 'correct': 75},
             'steps': 200,
             'final_window': 20,
             'runs': [{'seed': 0,
                       'first_loss': 3.433899164199829,
                       'last_loss': 2.9147491455078125,
                       'final_loss': 3.0883267760276794,
                       'easy_recall': 0.0625},
                      {'seed': 1,
                       'first_loss': 3.4339346885681152,
                       'last_loss': 2.9925217628479004,
                       'final_loss': 3.0236373066902162,
                       'easy_recall': 0.046875},
                      {'seed': 2,
                       'first_loss': 3.4339821338653564,
                       'last_loss': 2.8575520515441895,
                       'final_loss': 3.010843741893768,
                       'easy_recall': 0.0625}]}}
TRAIN_FLIPS = 1             # (a) keypoints or matches the card may flip
# (b) each of the 20 losses against its anchor: (steps, rtol) tiers. The
# first 3 hold the forward, the losses and Adam's first two updates; after
# them Adam amplifies the rounding of two devices' f32 convolutions (the
# port on the CPU lies <= 6.5e-6 from the anchors over steps 0-4 and 7.9e-3
# by step 18; on the H100 under highp 1.2e-7, 1.5e-6 and 9.4e-6 over steps
# 0-2, then 2.0e-4 at step 3 and 1.9e-2 by step 17)
TRAIN_LOSS_RTOL = ((3, 1e-4), (20, 5e-2))
TRAIN_SCRATCH_STEPS = 300   # (c) tests/test_train_superpoint.py:31-40
TRAIN_SCRATCH_BARS = dict(loss_ratio=0.6, recall=0.25, precision=0.2)
# (d) the port's seeds (the anchors'), whose mean final loss and easy
# recall must lie inside the JAX seeds' [min, max] widened by half its
# width, and for the recall by at least one retrieval of the 64: the JAX
# seeds' 3, 4 and 4 correct of 64 make a band one retrieval wide, where one
# run's count has a binomial spread of about 2 (sqrt(64 p (1 - p)))
TRAIN_NETVLAD_SEEDS = (0, 1, 2)
TRAIN_RESOLUTION = {"final_loss": 0.0, "easy_recall": 1 / 64}
TRAIN_RELOAD_ATOL = 1e-5    # (e) against the f16-rounded weights' forward
TRAIN_TIMED_STEPS = 10      # (f) steps timed per row, after 2 warm-up steps
K2_TRAIN_SHAPES = ((1, 64, 96), (16, 64, 96))
# Phase 13a: the 10-drone tier and the loop-dense window
D10_ATE_BAR = 0.15          # tests/test_scale10.py:25, held at 10 x 100
DENSE_ITERS = 25            # bench.py:322
D10_DEMO_STEPS = 15         # keyframe steps of the 10 x 30 image demo
K2_D10_SHAPE = (80, 208, 400)   # their K2 batch: 80 views
# Phase 14a: the measurement entry points. bf16 trunks against f32 at
# tests/test_bf16_frontend.py's bars; the CPU baseline and the bench at
# their own sizes with fewer repetitions
# (the script's time limit): the baseline's rows each timed once with no
# warm-up call but torch_cpu_bt's, the bench's solver rows each timing
# their first solve (BENCH_REPS), where the modules warm up and take
# medians of 3 (baseline), 5 and 3 (bench); the online window held to
# ONLINE_ANCHORS
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tools/online_window_anchors.py
# --solves 12).
BF16_HW, BF16_BATCH = (208, 400), 4
BF16_BARS = dict(heat=0.03, desc_cos=0.995, kp_matched=0.9, kp_px=1.0,
                 global_cos=0.99, pairwise=0.02)
# the bench's K2 batches: the bf16 rows' 4, 16, 64 views, the fused row's
# 4 stereo pairs
K2_BENCH_SHAPES = ((4, 208, 400), (8, 208, 400), (16, 208, 400),
                   (64, 208, 400))
BENCH_REPS = dict(reps=1, big_reps=1, frontend_runs=1, warm_up=False)
CPU_BASELINE_REPS = 1
CPU_BASELINE_ITERS = 20     # the module's 100 took 60 s of the host
ONLINE_SOLVES = 12
# Phase 15a: the repository's remaining tools (omniswarm_torch/tools/). The
# window-scale sweep at full width, one timed solve a size, held to the JAX
# package's CPU anchors on its fused-level branch (PYTHONPATH=.
# JAX_PLATFORMS=cpu python tools/solver_anchors.py --only window_scale
# --frames F, one F a process); the largest F also solved twice.
SWEEP_FRAMES = (1024, 2048, 4096, 8192, 16384)
SWEEP_ITERS = 25
SWEEP_REPEATED = 16384
SWEEP_ANCHORS = {
    1024: dict(cost=1198.1591796875, iterations=25, loops=35,
              linear='smw',
              relative_ate=0.0441221978975926),
    2048: dict(cost=2392.098876953125, iterations=25, loops=75,
              linear='smw',
              relative_ate=0.047404607481641194),
    4096: dict(cost=4951.50439453125, iterations=25, loops=155,
              linear='smw',
              relative_ate=0.053224952009715644),
    8192: dict(cost=9719.021484375, iterations=25, loops=315,
              linear='pcg',
              relative_ate=0.04623721756314233),
    16384: dict(cost=19926.568359375, iterations=25, loops=635,
               linear='pcg',
               relative_ate=0.04771133242956223),
}
# The replay tool on simulator-written CSV logs against the reference's
# tools/replay_eval.py on the CPU (tools/solver_anchors.py --only replay),
# both with max_solver_time 1e-6 s: each solve's window, status and
# iterations equal, its cost within 1%, summary.json within 1e-3 m (rad):
# about ten times what the port reads (1.3e-4 on the CPU, 9.7e-5 on an
# H100), and below the smallest yaw RMSE (0.0046 rad)
REPLAY_LOGS = dict(drones=3, seconds=30.0, seed=0)
REPLAY_OFFSETS = (0.0, 2.0, 4.0)
REPLAY_COST_RTOL = 0.01
REPLAY_ATOL = 1e-3
REPLAY_ANCHOR = {'solves': [{'solved': True,
             'num_frames': 16,
             'cost': 3.2649974822998047,
             'iterations': 100},
            {'solved': True,
             'num_frames': 24,
             'cost': 5.898416519165039,
             'iterations': 100},
            {'solved': True,
             'num_frames': 32,
             'cost': 11.636457443237305,
             'iterations': 25},
            {'solved': True,
             'num_frames': 40,
             'cost': 14.655035018920898,
             'iterations': 25},
            {'solved': True,
             'num_frames': 40,
             'cost': 16.752758026123047,
             'iterations': 25}],
 'summary': {'per_drone': {'0': {'ate_pos': 0.051060286589929414,
                                 'yaw_rmse': 0.006428801258388484},
                           '1': {'ate_pos': 0.06254567122546667,
                                 'yaw_rmse': 0.004650784321776963},
                           '2': {'ate_pos': 0.1159529645644884,
                                 'yaw_rmse': 0.014813279285873632}},
             'relative_ate_pairs': {'0->1': 0.084728506271519,
                                    '0->2': 0.05180538886133099,
                                    '1->0': 0.0942967178763981,
                                    '1->2': 0.06913753646668683,
                                    '2->0': 0.06387001236018915,
                                    '2->1': 0.07816489887790623},
             'mean_relative_ate': 0.07366717678567171}}
# Two network testers and the spy over loopback multicast, beside the
# textured eval on the bundled SuperPoint checkpoints (photo_v2's rows are
# phase 12a's (a) rows: held to TRAIN_ANCHORS)
CONVERT_SHAPE = (4, 208, 400)       # 16a (a): the front-end's views
CONVERT_BARS = dict(atol=1e-4, rtol=1e-3)   # tests/test_weight_conversion.py
DRIFT_ORDER = ("other", "this")     # 16a (b): one pair of children,
DRIFT_REPS = 1                      # one timed solve each
COMM_FRAMES = (256,)                # 16a (c)
BUS_PORT = 17951
BUS_SECONDS = 5
TEXTURED_CKPTS = ("magicpoint=weights/superpoint_synthetic.npz",
                  "photometric=weights/superpoint_photometric.npz",
                  "photo_v2=weights/superpoint_photo_v2.npz")
TEXTURED_N_EVAL = 24
ONLINE_ANCHORS = {'frames': 1024,
                  'loops': 2000,
                  'solves': [{'window': [[100, 1123]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [209, '73b64ac6f191'],
                                          '0-3': [207, '0fead4feebdf'],
                                          '0-4': [195, '1210ab5d7faf']},
                              'iterations': 8,
                              'cost': 1096.083496,
                              'finish_init': True},
                             {'window': [[100, 985], [987, 1123],
                                         [1125, 1125]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [210, '55da2e4810ba'],
                                          '0-3': [207, '0fead4feebdf'],
                                          '0-4': [196, '3e47b029afd3']},
                              'iterations': 15,
                              'cost': 1095.751953,
                              'finish_init': True},
                             {'window': [[100, 665], [667, 985], [987, 1123],
                                         [1125, 1126]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [207, '0fead4feebdf'],
                                          '0-4': [196, '3e47b029afd3']},
                              'iterations': 5,
                              'cost': 1096.31604,
                              'finish_init': True},
                             {'window': [[100, 189], [191, 665], [667, 985],
                                         [987, 1123], [1125, 1127]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [207, '0fead4feebdf'],
                                          '0-4': [197, 'b996641c7d58']},
                              'iterations': 5,
                              'cost': 1097.131592,
                              'finish_init': True},
                             {'window': [[100, 189], [191, 484], [486, 665],
                                         [667, 985], [987, 1123],
                                         [1125, 1128]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [207, '0fead4feebdf'],
                                          '0-4': [197, 'b996641c7d58']},
                              'iterations': 7,
                              'cost': 1097.605347,
                              'finish_init': True},
                             {'window': [[100, 189], [191, 374], [376, 484],
                                         [486, 665], [667, 985], [987, 1123],
                                         [1125, 1129]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [207, '0fead4feebdf'],
                                          '0-4': [198, 'f3681ddac16c']},
                              'iterations': 4,
                              'cost': 1097.28186,
                              'finish_init': True},
                             {'window': [[100, 189], [191, 374], [376, 484],
                                         [486, 665], [667, 917], [919, 985],
                                         [987, 1123], [1125, 1130]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [207, '0fead4feebdf'],
                                          '0-4': [198, 'f3681ddac16c']},
                              'iterations': 4,
                              'cost': 1097.595459,
                              'finish_init': True},
                             {'window': [[100, 124], [126, 189], [191, 374],
                                         [376, 484], [486, 665], [667, 917],
                                         [919, 985], [987, 1123],
                                         [1125, 1131]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [208, 'f00eee3133c7'],
                                          '0-4': [198, 'f3681ddac16c']},
                              'iterations': 5,
                              'cost': 1097.336426,
                              'finish_init': True},
                             {'window': [[100, 124], [126, 189], [191, 374],
                                         [376, 469], [471, 484], [486, 665],
                                         [667, 917], [919, 985], [987, 1123],
                                         [1125, 1132]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [208, 'f00eee3133c7'],
                                          '0-4': [198, 'f3681ddac16c']},
                              'iterations': 7,
                              'cost': 1097.515625,
                              'finish_init': True},
                             {'window': [[100, 124], [126, 189], [191, 348],
                                         [350, 374], [376, 469], [471, 484],
                                         [486, 665], [667, 917], [919, 985],
                                         [987, 1123], [1125, 1133]],
                              'inliers': {'0-1': [234, 'f02276f7ee38'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [209, '0014ecce9922'],
                                          '0-4': [198, 'f3681ddac16c']},
                              'iterations': 3,
                              'cost': 1098.078003,
                              'finish_init': True},
                             {'window': [[100, 124], [126, 189], [191, 348],
                                         [350, 374], [376, 469], [471, 484],
                                         [486, 665], [667, 763], [765, 917],
                                         [919, 985], [987, 1123],
                                         [1125, 1134]],
                              'inliers': {'0-1': [235, '05fcf67668dd'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [210, 'ae40ce0dc3bf'],
                                          '0-4': [198, 'f3681ddac16c']},
                              'iterations': 5,
                              'cost': 1098.700684,
                              'finish_init': True},
                             {'window': [[100, 124], [126, 189], [191, 348],
                                         [350, 374], [376, 469], [471, 484],
                                         [486, 555], [557, 665], [667, 763],
                                         [765, 917], [919, 985], [987, 1123],
                                         [1125, 1135]],
                              'inliers': {'0-1': [235, '05fcf67668dd'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [210, 'ae40ce0dc3bf'],
                                          '0-4': [198, 'f3681ddac16c']},
                              'iterations': 5,
                              'cost': 1099.76001,
                              'finish_init': True},
                             {'window': [[100, 124], [126, 189], [191, 348],
                                         [350, 352], [354, 374], [376, 469],
                                         [471, 484], [486, 555], [557, 665],
                                         [667, 763], [765, 917], [919, 985],
                                         [987, 1123], [1125, 1136]],
                              'inliers': {'0-1': [235, '05fcf67668dd'],
                                          '0-2': [211, 'ce77e8179eb8'],
                                          '0-3': [210, 'ae40ce0dc3bf'],
                                          '0-4': [199, 'd5afaf0cb4c1']},
                              'iterations': 4,
                              'cost': 1099.808472,
                              'finish_init': True}]}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def k1_recording():
    """Sets K1's counts to 0 and counts the (m, t) of every kernel launch
    (the wrapper counts) into the Counter it yields, filled on exit."""
    from omniswarm_torch.benchutil import k1_levels
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    levels = collections.Counter()
    fused_reduction_level.launches = 0
    fused_reduction_level_ref.calls = 0
    with k1_levels() as launched:
        try:
            yield levels
        finally:
            levels.update(launched)


@contextlib.contextmanager
def k2_recording():
    """Sets K2's and K3's counts and their plain versions' to 0 and records
    the (B, H, W) of every K2 launch (the wrapper counts) into the Counter
    it yields."""
    from omniswarm_torch import kernels
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1, retrieval_top1_ref)

    launch, shapes = kernels.grid_nms, collections.Counter()

    def recording_launch(heat, nms_dist):
        shapes[tuple(heat.shape)] += 1
        return launch(heat, nms_dist)

    kernels.grid_nms = recording_launch
    grid_nms.launches = retrieval_top1.launches = 0
    grid_nms_ref.calls = retrieval_top1_ref.calls = 0
    try:
        yield shapes
    finally:
        kernels.grid_nms = launch


def kernel_checks() -> dict:
    """Phase 2: the cuda tests of CARD_TESTS in one pytest process; every
    test passes and none skips. Returns the count and seconds, and per test
    function the tests passed and the largest of each error it recorded."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = Path(tmp) / "card.xml"
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m",
             "cuda", "-p", "no:cacheprovider", "-o", "junit_family=xunit1",
             f"--junitxml={report}", *CARD_TESTS],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        cases = (ET.parse(report).getroot().iter("testcase")
                 if report.exists() else [])
        by_test, outcomes = {}, collections.Counter()
        for case in cases:
            outcome = next((c.tag for c in case
                            if c.tag in ("failure", "error", "skipped")),
                           "passed")
            outcomes[outcome] += 1
            test = (case.get("classname").rsplit(".", 1)[-1] + "::"
                    + case.get("name").split("[")[0])
            row = by_test.setdefault(test, {"passed": 0})
            row["passed"] += outcome == "passed"
            for prop in case.iter("property"):
                name, value = prop.get("name"), float(prop.get("value"))
                row[name] = max(row.get(name, value), value)
    seconds = time.perf_counter() - t0
    print(f"card tests: pytest rc {run.returncode} {dict(outcomes)} in "
          f"{seconds:.1f} s", flush=True)
    ok = (run.returncode == 0 and outcomes["passed"] > 0
          and set(outcomes) == {"passed"})
    if not ok:
        print(run.stdout[-6000:], run.stderr[-2000:], sep="\n", flush=True)
    check(ok, f"the kernels' card checks: rc {run.returncode}, "
          f"{dict(outcomes)}")
    return dict(tests=outcomes["passed"], seconds=round(seconds, 1),
                by_test=by_test)


def check_k1_levels(F: int, levels, iters: int, D: int = 5) -> int:
    """K1's launches of a path just run: every launch a kernel launch, at the
    level shapes of SOLVE_LEVELS for F and D, each once per iteration."""
    from omniswarm_torch.benchutil import SOLVE_LEVELS
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    check(fused_reduction_level_ref.calls == 0,
          "the plain level ran on the card path")
    want = {(m, t): iters for F_, D_, m, ts in SOLVE_LEVELS
            if (F_, D_) == (F, D) for t in ts}
    check(dict(levels) == want, f"K1 level shapes {dict(levels)}, "
          f"expected {want}")
    return fused_reduction_level.launches


def check_repeat(name: str, a_cost: float, b_cost: float, a_poses,
                 b_poses) -> None:
    """Two solves of one path in one process: bit-equal cost and poses."""
    same = bool(np.array_equal(a_poses, b_poses))
    print(f"{name} again: cost {b_cost!r} vs {a_cost!r} poses equal {same}",
          flush=True)
    check(a_cost == b_cost and same,
          f"two {name} solves differ: costs {a_cost!r} and {b_cost!r}, max "
          f"pose diff {float(np.abs(a_poses - b_poses).max())}")


def main_path_phase(F: int, per_iter: int, ref_cost: float, ate_bar: float):
    import torch

    from omniswarm_torch.entry import entry

    iters = SOLVER_ITERS
    with k1_recording() as levels:
        res = entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                    max_iterations=iters)
    launches = check_k1_levels(F, levels, iters)
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

    again = entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                  max_iterations=iters)
    check_repeat(f"main path F={F}", res.cost, again.cost, res.poses,
                 again.poses)

    unfused = entry(device="cuda", num_frames=F, num_drones=5, seed=0,
                    max_iterations=iters, fused=False)
    rel = abs(unfused.cost - res.cost) / abs(unfused.cost)
    print(f"main path F={F} fused=False: cost {unfused.cost:.4f} rel delta "
          f"{rel:.3e} solve {unfused.solve_s * 1e3 / unfused.iterations:.2f}"
          f" ms/iteration", flush=True)
    check(unfused.k1_launches == 0, "fused=False launched the kernel")
    check(rel <= 1e-3, f"fused and unfused costs differ by {rel:.3e}")
    main_poses[F] = res.poses
    return dict(F=F, cost=res.cost, initial_cost=res.initial_cost,
                iterations=res.iterations, relative_ate=res.relative_ate,
                launches=launches, repeat_cost=again.cost,
                levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
                ms_per_iteration=res.solve_s * 1e3 / res.iterations,
                unfused_cost=unfused.cost,
                unfused_ms_per_iteration=(unfused.solve_s * 1e3
                                          / unfused.iterations))


main_poses = {}          # the main paths' solved poses, by F


def held(name: str, got: float, want: float, rtol: float = 0.01,
         atol: float = 0.0) -> None:
    check(math.isfinite(got) and abs(got - want) <= atol + rtol * abs(want),
          f"{name} {got!r} not within rtol {rtol} atol {atol} of its "
          f"anchor {want!r}")


def timed(fn):
    """(result, synchronised wall seconds) of fn()."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def report(name: str, res, seconds: float, **extra) -> dict:
    """Print and return a solve's numbers (ms per LM iteration)."""
    cost = np.asarray(res.cost.cpu() if hasattr(res.cost, "cpu")
                      else res.cost, np.float64)
    out = dict(path=name, cost=cost.tolist(), iterations=res.iterations,
               ms_per_iteration=seconds * 1e3 / res.iterations, **extra)
    print(f"solver path {name}: cost {out['cost']} iterations "
          f"{res.iterations} {out['ms_per_iteration']:.2f} ms/iteration "
          + " ".join(f"{k} {v}" for k, v in extra.items()), flush=True)
    return out


def pcg_phase(smw: dict, per_iter: int) -> dict:
    """linear="pcg" at F=1024 through entry(), against an exact-Woodbury
    solve and its anchor; K1 must launch per_iter times an iteration at the
    main path's level shapes."""
    from omniswarm_torch.entry import entry
    from omniswarm_torch.eval import metrics

    F, iters, a = 1024, SOLVER_ITERS, SOLVER_ANCHORS["pcg_1024"]
    kw = dict(device="cuda", num_frames=F, num_drones=5, seed=0,
              max_iterations=iters)
    with k1_recording() as levels:
        res = entry(linear="pcg", **kw)
    launches = check_k1_levels(F, levels, iters)
    again = entry(linear="pcg", **kw)
    check_repeat("pcg F=1024", res.cost, again.cost, res.poses, again.poses)
    # near convergence, as tests/test_bt_lm.py:87-99 compares the paths
    kw["max_iterations"] = 50
    pcg50 = entry(linear="pcg", **kw)
    exact = entry(exact_linear=True, **kw)
    vs_exact = metrics.mean_relative_ate(pcg50.poses, exact.poses)
    out = dict(path="pcg F=1024", F=F, cost=res.cost,
               initial_cost=res.initial_cost, iterations=res.iterations,
               relative_ate=res.relative_ate, pcg50_cost=pcg50.cost,
               pcg50_relative_ate=pcg50.relative_ate, exact_cost=exact.cost,
               exact_relative_ate=exact.relative_ate, ate_vs_exact=vs_exact,
               smw_cost=smw["cost"], smw_relative_ate=smw["relative_ate"],
               ate_vs_smw=metrics.mean_relative_ate(res.poses,
                                                    main_poses[F]),
               launches=launches,
               levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
               ms_per_iteration=res.solve_s * 1e3 / res.iterations,
               exact_ms_per_iteration=exact.solve_s * 1e3 / exact.iterations,
               smw_ms_per_iteration=smw["ms_per_iteration"])
    print("solver path", json.dumps(out), flush=True)
    check(math.isfinite(res.cost) and res.cost < res.initial_cost,
          f"pcg cost {res.cost} not below initial {res.initial_cost}")
    held("pcg F=1024 cost", res.cost, a["cost"])
    held("pcg F=1024 cost at 50 iterations vs the exact-Woodbury solve",
         pcg50.cost, exact.cost, rtol=5e-3)
    check(vs_exact < 0.02, f"pcg relative ATE vs exact {vs_exact} >= 0.02")
    check(res.relative_ate < 0.1, f"pcg relative ATE {res.relative_ate}")
    check(res.iterations == iters and launches == per_iter * iters,
          f"pcg: {res.iterations} iterations, {launches} K1 launches")
    return out


def exact_phase() -> dict:
    from omniswarm_torch.entry import entry

    a = SOLVER_ANCHORS["exact_100"]
    runs = [entry(device="cuda", num_frames=100, num_drones=5, seed=0,
                  max_iterations=SOLVER_ITERS, exact_linear=True)
            for _ in range(2)]
    res = runs[0]
    check_repeat("exact F=100", res.cost, runs[1].cost, res.poses,
                 runs[1].poses)
    out = dict(path="exact F=100", cost=res.cost,
               initial_cost=res.initial_cost, iterations=res.iterations,
               relative_ate=res.relative_ate, k1_launches=res.k1_launches,
               ms_per_iteration=res.solve_s * 1e3 / res.iterations)
    print("solver path", json.dumps(out), flush=True)
    held("exact F=100 cost", res.cost, a["cost"])
    check(res.relative_ate < 0.08, f"exact relative ATE {res.relative_ate}")
    check(res.k1_launches == 0, "the exact path launched K1")
    check(res.iterations == SOLVER_ITERS, f"{res.iterations} iterations")
    return out


def batch_phase(data, graph) -> dict:
    import torch

    from omniswarm_torch.benchutil import batch_inits
    from omniswarm_torch.eval import metrics
    from omniswarm_torch.solver.dense import lm_solve_bt, lm_solve_bt_batched
    from omniswarm_torch.solver.fused_level import fused_reduction_level

    a = SOLVER_ANCHORS["batch_100"]
    kw = dict(device="cuda", max_iterations=SOLVER_ITERS,
              function_tolerance=0.0)
    inits = batch_inits(data.vio, 8)
    launches0 = fused_reduction_level.launches
    res, seconds = timed(lambda: lm_solve_bt_batched(graph, inits, **kw))
    again = lm_solve_bt_batched(graph, inits, **kw)
    poses = res.poses.cpu().numpy()
    check_repeat("batch-8 F=100", tuple(res.cost.tolist()),
                 tuple(again.cost.tolist()), poses,
                 again.poses.cpu().numpy())
    check(fused_reduction_level.launches == launches0,
          "the batched path launched K1")
    costs = res.cost.cpu().numpy().astype(np.float64)
    singles = [float(lm_solve_bt(graph, p, **kw).cost) for p in inits]
    ate0 = metrics.mean_relative_ate(poses[0], data.gt)
    out = report("batch-8 F=100", res, seconds, single_costs=singles,
                 lane0_relative_ate=ate0,
                 ms_per_lane_iteration=seconds * 1e3 / res.iterations / 8)
    check(bool(torch.isfinite(res.poses).all()), "batch poses not finite")
    for b in range(8):
        held(f"batch lane {b} cost vs its single solve", costs[b],
             singles[b], rtol=0.05, atol=0.5)
        held(f"batch lane {b} cost", costs[b], a["cost"][b], rtol=0.05,
             atol=0.5)
    check(ate0 < 0.08, f"batch lane 0 relative ATE {ate0}")
    check(res.iterations == SOLVER_ITERS, f"{res.iterations} iterations")
    return out


def covariance_phase(graph) -> dict:
    import torch

    from omniswarm_torch.convert import dense_graph_to_torch
    from omniswarm_torch.solver.dense import assemble_dense, pose_covariances

    a = SOLVER_ANCHORS["cov_100"]
    poses = main_poses[100]
    query = np.asarray([[99, d] for d in range(5)], np.int64)
    cov, seconds = timed(lambda: pose_covariances(graph, poses, query,
                                                  device="cuda"))
    again = pose_covariances(graph, poses, query, device="cuda")
    check(torch.equal(cov, again), "two covariance runs differ")
    cov = cov.cpu().numpy()
    H, _, _ = assemble_dense(dense_graph_to_torch(graph, "cuda"),
                             torch.from_numpy(poses).cuda())
    H = H.double().cpu().numpy()
    Hinv = np.linalg.inv(H + 1e-6 * np.eye(H.shape[0]))
    diag = np.diagonal(cov, axis1=1, axis2=2)
    err = 0.0
    for q, (f, d) in enumerate(query):
        i = 4 * (f * 5 + d)
        ref = Hinv[i:i + 4, i:i + 4]
        excess = np.abs(cov[q] - ref) - (5e-4 + 0.05 * np.abs(ref))
        check(bool((excess <= 0).all()), f"covariance of {f, d} differs from "
              f"the dense inverse by {np.abs(cov[q] - ref).max():.3e}")
        err = max(err, float(np.abs(cov[q] - ref).max()))
    excess = np.abs(diag - np.asarray(a["diag"])) - (
        5e-4 + 0.05 * np.abs(np.asarray(a["diag"])))
    check(bool((excess <= 0).all()), f"covariance diagonals {diag.tolist()} "
          f"differ from their anchors {a['diag']}")
    out = dict(path="covariances F=100", query=query.tolist(),
               diag=diag.tolist(), max_abs_err_vs_dense_inverse=err,
               ms=seconds * 1e3)
    print("solver path", json.dumps(out), flush=True)
    return out


def gold_phase(data, graph) -> list:
    from omniswarm_torch.benchutil import batch_inits
    from omniswarm_torch.eval import metrics
    from omniswarm_torch.sim.pipeline import build_graph_from_sim
    from omniswarm_torch.solver.dense import lm_solve_dense
    from omniswarm_torch.solver.gauss_newton import (lm_solve,
                                                     lm_solve_multi_init)

    kw = dict(device="cuda", max_iterations=SOLVER_ITERS,
              function_tolerance=0.0)
    fg, finit = build_graph_from_sim(data, enable_detections=True)
    inits = batch_inits(data.vio, 4)
    paths = (("dense_100", "lm_solve_dense F=100",
              lambda: lm_solve_dense(graph, data.vio, **kw)),
             ("generic_100", "lm_solve F=100",
              lambda: lm_solve(fg, finit, **kw)),
             ("multi_100", "lm_solve_multi_init x4 F=100",
              lambda: lm_solve_multi_init(fg, inits, **kw)))
    out, ate = [], {}
    for key, name, solve in paths:
        res, seconds = timed(solve)
        again = solve()
        poses = res.poses.cpu().numpy()
        check_repeat(name, float(res.cost), float(again.cost), poses,
                     again.poses.cpu().numpy())
        ate[key] = metrics.mean_relative_ate(poses, data.gt)
        lanes = len(inits) if key == "multi_100" else 1
        out.append(report(name, res, seconds, relative_ate=ate[key],
                          lanes=lanes, ms_per_lane_iteration=(
                              seconds * 1e3 / res.iterations / lanes)))
        check(float(res.cost) < float(res.initial_cost),
              f"{name} cost not below initial")
        held(f"{name} cost", float(res.cost), SOLVER_ANCHORS[key]["cost"])
    held("dense cost vs generic", out[0]["cost"], out[1]["cost"], rtol=5e-2)
    check(ate["dense_100"] < 0.08, f"dense relative ATE {ate['dense_100']}")
    check(abs(ate["dense_100"] - ate["generic_100"]) < 0.03,
          f"dense and generic relative ATE {ate}")
    return out


def solver_phases(paths: dict) -> dict:
    """Phase 4a: the rest of the solver package (see the docstring)."""
    from omniswarm_torch import sim
    from omniswarm_torch.solver.dense import dense_graph_from_sim

    out = {}
    t0 = time.perf_counter()
    out["pcg"] = pcg_phase(paths[1024], MAIN_PATHS[1][1])
    out["exact"] = exact_phase()
    data = sim.generate(sim.SimParams(num_drones=5, num_frames=100, seed=0))
    graph = dense_graph_from_sim(data)
    out["batch"] = batch_phase(data, graph)
    out["covariances"] = covariance_phase(graph)
    out["gold"] = gold_phase(data, graph)
    return out


def frontend_phase(prep):
    import torch

    from omniswarm_torch import kernels
    from omniswarm_torch.frontend_entry import (
        checksum_faults, frontend_entry, keyframe_checksums, summary)
    from omniswarm_torch.ops.frontend_kernels import (
        conv3x3, conv3x3_ref, conv_epilogue, conv_epilogue_ref, grid_nms,
        grid_nms_ref, retrieval_top1, retrieval_top1_ref)

    grid_nms.launches = retrieval_top1.launches = conv_epilogue.launches = 0
    conv3x3.launches = 0
    grid_nms_ref.calls = retrieval_top1_ref.calls = 0
    conv_epilogue_ref.calls = conv3x3_ref.calls = 0
    launch, first = kernels.grid_nms, []

    def keep_first(heat, nms_dist):
        """K2's launch; the first step's heat maps and output kept."""
        out = launch(heat, nms_dist)
        if not first:
            first.append((heat.clone(), nms_dist, out.clone()))
        return out

    kernels.grid_nms = keep_first
    try:
        res = frontend_entry(device="cuda", prep=prep)
    finally:
        kernels.grid_nms = launch
    k2, k3 = grid_nms.launches, retrieval_top1.launches
    epilogues, c1 = conv_epilogue.launches, conv3x3.launches
    plain_calls = (grid_nms_ref.calls + retrieval_top1_ref.calls
                   + conv_epilogue_ref.calls + conv3x3_ref.calls)
    heat, nms_dist, got = first[0]
    k2_heat_equal = torch.equal(got, grid_nms_ref(heat, nms_dist))
    out = summary(res)
    same = int((res.top1_idx == np.asarray(FE_ANCHORS["top1_idx"])).sum())
    faults, diffs = checksum_faults(keyframe_checksums(res.keyframes),
                                    FE_ANCHORS, 400, 208)
    out.update(k2_launches=k2, k3_launches=k3, epilogue_launches=epilogues,
               c1_launches=c1, k2_heat_shape=list(heat.shape),
               k2_heat_bit_equal=k2_heat_equal,
               top1_idx_equal=same, anchor_diffs=diffs,
               step_ms=[round(float(v), 3) for v in res.step_ms])
    print("frontend path", json.dumps(out), flush=True)
    check(plain_calls == 0,
          "a plain front-end kernel version ran on the card path")
    check(k2_heat_equal, "K2 on the first step's SuperPoint heat maps "
          "differs from its plain version")
    check(k2 == FE_STEPS and k3 == FE_STEPS,
          f"K2/K3 launched {k2}/{k3} times, expected {FE_STEPS} each")
    check(epilogues == 12 * FE_STEPS,
          f"the conv epilogue launched {epilogues} times, expected "
          f"{12 * FE_STEPS}")
    check(c1 == 0, f"C1 launched {c1} times on the stereo batch")
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


def rgbd_phase() -> dict:
    """Phase 7b: the RGB-D keyframes' entry point through its cell's driver
    (see the docstring)."""
    import torch

    from benchmark.run import cell, load_module
    from omniswarm_torch.ops.frontend_kernels import (
        conv3x3, conv3x3_ref, conv_epilogue, conv_epilogue_ref, grid_nms,
        grid_nms_ref, retrieval_top1, retrieval_top1_ref)

    c = cell(ROOT, RGBD_CELL)
    drv = load_module(c.driver, "chip_smoke_rgbd_driver").Driver(
        c.config, c.traffic, 0, torch.device("cuda"))
    conv3x3.launches = conv_epilogue.launches = grid_nms.launches = 0
    retrieval_top1.launches = 0
    conv3x3_ref.calls = conv_epilogue_ref.calls = grid_nms_ref.calls = 0
    retrieval_top1_ref.calls = 0
    ms, counts = [], collections.Counter()
    for _ in range(RGBD_STEPS):
        t0 = time.perf_counter()
        counts.update(drv.unit())
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(c1=conv3x3.launches, epilogue=conv_epilogue.launches,
                    k2=grid_nms.launches, k3=retrieval_top1.launches)
    plain_calls = (conv3x3_ref.calls + conv_epilogue_ref.calls
                   + grid_nms_ref.calls + retrieval_top1_ref.calls)
    drv.release()
    readings = drv.check()
    out = dict(counts, launches=launches, plain_calls=plain_calls,
               checks={k: [readings.get(k, math.inf), limit]
                       for k, limit in c.limits.items()},
               step_ms=[round(v, 3) for v in ms])
    print("rgbd path", json.dumps(out), flush=True)
    check(plain_calls == 0, "a plain front-end kernel version ran on the "
          "RGB-D path")
    want = dict(c1=9, epilogue=12, k2=1, k3=1)
    check(launches == {k: n * RGBD_STEPS for k, n in want.items()},
          f"RGB-D launches {launches} in {RGBD_STEPS} steps, expected "
          f"{want} a step")
    check(all(math.isfinite(v) and v <= limit
              for v, limit in out["checks"].values()),
          f"the RGB-D path departs from its reference: {out['checks']}")
    return out


def estimator_checks_k1(levels) -> list:
    """K1 at each level shape a path launched outside SOLVE_LEVELS (which
    the cuda tests check), on all three branches, against its plain version
    (these launches are not counted on the path)."""
    import torch

    from omniswarm_torch.benchutil import (SOLVE_LEVELS, check_level,
                                           random_level)
    from omniswarm_torch.core.precision import highp

    seen = {(m, t) for _, _, m, ts in SOLVE_LEVELS for t in ts}
    rng = np.random.default_rng(1)
    rows = []
    with highp():
        for m, t in sorted(set(levels) - seen):
            for branch in K1_BRANCHES:
                A, B, X0 = (torch.from_numpy(v).cuda()
                            for v in random_level(rng, 2 * t, m, branch))
                rows.append(dict(m=m, t=t, branch=branch,
                                 max_abs_err=check_level(A, B, X0)))
    return rows


def held_session(run: dict, name: str) -> None:
    """The held session against ESTIMATOR_ANCHORS: windows, finish_init and
    inlier sets equal up to and including a threshold tie (then only the
    bars), costs within 1%, final relative ATE and covariances."""
    from omniswarm_torch.estimator_entry import frame_runs

    a = ESTIMATOR_ANCHORS
    solves = run["solves"]
    check(len(solves) == len(a["solves"]),
          f"{name}: {len(solves)} solves, anchors {len(a['solves'])}")
    ties = [i for i, w in enumerate(a["solves"])
            if abs(w["cost_over_acpt"] - 1.0) <= EST_TIE]
    last = ties[0] if ties else len(solves) - 1
    for i, (got, want) in enumerate(zip(solves, a["solves"])):
        check(math.isfinite(got["cost"]), f"{name} solve {i}: cost "
              f"{got['cost']}")
        if i > last:
            continue
        check(frame_runs(got["frames"]) == want["frames"],
              f"{name} solve {i}: window {frame_runs(got['frames'])} vs "
              f"{want['frames']}")
        check(got["finish_init"] == want["finish_init"],
              f"{name} solve {i}: finish_init {got['finish_init']}")
        check(got["inliers"] == want["inliers"], f"{name} solve {i}: PCM "
              f"inliers {got['inliers']} vs {want['inliers']}")
        check((got["linear"], got["pack"], got["lanes"]) == (
            want["linear"], want["pack"], want["lanes"]),
            f"{name} solve {i}: path {got['linear']} pack {got['pack']} "
            f"lanes {got['lanes']}")
        if i < last or not ties:
            held(f"{name} solve {i} cost", got["cost"], want["cost"],
                 rtol=EST_COST_RTOL)
    final = run["final"]
    ate = final["relative_ate"]
    check(ate is not None and ate <= EST_ATE_BAR
          and abs(ate - a["relative_ate"]) <= EST_ATE_TOL,
          f"{name}: final relative ATE {ate} (anchor {a['relative_ate']})")
    if not ties:
        diag = {int(d): v for d, v in final["cov_diag"].items()}
        for d, want in a["cov_diag"].items():
            got = np.asarray(diag[int(d)])
            excess = np.abs(got - want) - (EST_COV_ATOL
                                           + EST_COV_RTOL * np.abs(want))
            check(bool((excess <= 0).all()), f"{name}: covariance diagonal "
                  f"of drone {d} {got.tolist()} vs anchor {want}")
    p = run["predictions"]
    check(p["count"] > 0 and p["finite"] and p["self_max_abs"] <= 1e-6,
          f"{name}: predictions {p}")


def deployed_session(run: dict) -> None:
    """The shipped gate (acpt_cost 100), held to bars: finite costs,
    finish_init false after the first solve above the gate (and the next
    solve a multi-init), every multi-init solve's result at relative ATE
    within the bar, finite predictions."""
    solves = run["solves"]
    for i, s in enumerate(solves):
        check(math.isfinite(s["cost"]), f"deployed solve {i}: cost "
              f"{s['cost']}")
        check(s["finish_init"] == (s["cost"] < EST_DEPLOYED_ACPT),
              f"deployed solve {i}: cost {s['cost']} finish_init "
              f"{s['finish_init']}")
        if i:
            check(s["multi_init"] == (not solves[i - 1]["finish_init"]),
                  f"deployed solve {i}: multi_init {s['multi_init']}")
        if s["multi_init"]:
            check(s["result_ate"] <= EST_ATE_BAR, f"deployed solve {i}: "
                  f"re-init relative ATE {s['result_ate']}")
    check(any(s["cost"] >= EST_DEPLOYED_ACPT for s in solves),
          "no deployed solve went above the gate")
    p = run["predictions"]
    check(p["count"] > 0 and p["finite"], f"deployed predictions {p}")


def estimator_phase() -> dict:
    """Phase 7a: the estimator path (see the docstring)."""
    from omniswarm_torch.estimator_entry import estimator_entry
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)
    from omniswarm_torch.utils.telemetry import GLOBAL

    t0 = time.perf_counter()
    acpt = ESTIMATOR_ANCHORS["acpt_cost"]
    pcm0 = GLOBAL.timer("pcm.launch_to_finish")
    pcm0 = (pcm0.count, pcm0.total_ms)
    with k1_recording() as levels:
        run = estimator_entry(device="cuda", acpt_cost=acpt)
    launches = fused_reduction_level.launches
    check(fused_reduction_level_ref.calls == 0,
          "the plain level ran on the estimator path")
    pcm1 = GLOBAL.timer("pcm.launch_to_finish")
    pcm_ms = ((pcm1.total_ms - pcm0[1]) / (pcm1.count - pcm0[0])
              if pcm1.count > pcm0[0] else None)
    for i, s in enumerate(run["solves"]):
        print(f"estimator held solve {i}: {len(s['frames'])} keyframes "
              f"F={s['F']} {'multi-init' if s['multi_init'] else 'warm'} "
              f"lanes {s['lanes']} {s['linear']} pack {s['pack']} cost "
              f"{s['cost']!r} iterations {s['iterations']} finish_init "
              f"{s['finish_init']} host {s['host_ms']:.1f} ms device "
              f"{s['device_ms']:.1f} ms K1 {s['k1_launches']}", flush=True)
    print(f"estimator held session: relative ATE "
          f"{run['final']['relative_ate']!r} predictions "
          f"{run['predictions']} K1 launches {launches} at "
          f"{dict(levels)}", flush=True)
    held_session(run, "held session")
    check(launches > 0, "K1 never launched on the estimator path")
    checked = estimator_checks_k1(levels)

    again = estimator_entry(device="cuda", acpt_cost=acpt)
    same = ([s["cost"] for s in again["solves"]]
            == [s["cost"] for s in run["solves"]]
            and np.array_equal(again["estimate"], run["estimate"]))
    print(f"estimator held session again: bit-equal {same}", flush=True)
    check(same, "two held sessions differ: costs "
          f"{[s['cost'] for s in run['solves']]} and "
          f"{[s['cost'] for s in again['solves']]}")

    t1 = time.perf_counter()
    deployed = estimator_entry(device="cuda", acpt_cost=EST_DEPLOYED_ACPT)
    deployed_s = time.perf_counter() - t1
    for i, s in enumerate(deployed["solves"]):
        print(f"estimator deployed solve {i}: "
              f"{'multi-init' if s['multi_init'] else 'warm'} lanes "
              f"{s['lanes']} {s['linear']} pack {s['pack']} cost "
              f"{s['cost']!r} iterations {s['iterations']} finish_init "
              f"{s['finish_init']} result ATE {s['result_ate']:.5f} "
              f"{s['host_ms'] + s['device_ms']:.1f} ms", flush=True)
    ema = deployed["iter_ms_ema"]
    budget = None
    if ema:
        budget = min(60, max(25, (int(0.5e3 / max(ema, 1e-3)) // 25) * 25))
    print(f"estimator deployed session {deployed_s:.1f} s: per-iteration "
          f"ms (EMA) {ema!r}, so max_solver_time=0.5 would allow {budget} "
          f"iterations", flush=True)
    deployed_session(deployed)

    def split(key):
        solves = run["solves"] + deployed["solves"]
        return {kind: (float(np.median([s[key] for s in solves
                                        if s["multi_init"] == multi]))
                       if any(s["multi_init"] == multi for s in solves)
                       else None)
                for kind, multi in (("warm", False), ("multi_init", True))}

    out = dict(
        host_ms_median=split("host_ms"), device_ms_median=split("device_ms"),
        pcm_launch_to_finish_ms_mean=pcm_ms,
        predict_us_median=run["predictions"]["us_median"],
        paths=[[s["linear"], s["pack"], s["lanes"]] for s in run["solves"]],
        deployed_paths=[[s["linear"], s["pack"], s["lanes"]]
                        for s in deployed["solves"]],
        k1_launches=launches,
        k1_levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
        k1_checked=checked, relative_ate=run["final"]["relative_ate"],
        deployed_costs=[s["cost"] for s in deployed["solves"]],
        deployed_iter_ms_ema=ema, deployed_budget_iterations=budget,
        seconds=time.perf_counter() - t0)
    print("estimator path", json.dumps(out), flush=True)
    return out


def demo_flips(got: dict, want: dict) -> list:
    """The loop keys in one run's set and not the other's, each marked
    + (only in this run) or - (only in the anchors)."""
    g = {tuple(k) for k in got["loop_keys"]}
    w = {tuple(k) for k in want["loop_keys"]}
    return ([["+"] + list(k) for k in sorted(g - w)]
            + [["-"] + list(k) for k in sorted(w - g)])


def same_demo_run(a: dict, b: dict) -> bool:
    """Two runs of a demo bit-equal: loop keys, costs and estimates."""
    return (a["loop_keys"] == b["loop_keys"]
            and [d.get("cost") for d in a["per_drone"]]
            == [d.get("cost") for d in b["per_drone"]]
            and all(x is not None and y is not None and np.array_equal(x, y)
                    for x, y in zip(a["estimates"], b["estimates"])))


def detector_parity(prep, card: str = "cuda") -> dict:
    """Drone 0's LoopDetector on the card and on the CPU, fed the image
    demo's keyframes at the demo's tick shapes (each keyframe step: its
    own keyframe, Qb 1, then the 4 peers' as one batch, Qb 4; 16 lanes per
    query, the demo's Kb) with the same Gumbel noise, drawn on the CPU and
    uploaded. Lane by lane, retrieval and the matches must be equal and
    the PnP inlier sets may differ on at most DET_LANE_SHARE of the live
    lanes; the accepted loops must be equal edge for edge (drones, stamps)
    with inlier counts within DET_INLIER_SLACK and dpose within
    DET_DPOSE_ATOL. Extraction runs on the card first; its K2 launches are
    outside the counted runs.
    """
    import torch

    from omniswarm_torch.config import FrontendParams
    from omniswarm_torch.demo_entry import IMAGE_FP
    from omniswarm_torch.frontend_entry import BASELINE
    from omniswarm_torch.swarm.loop_cam import OmniLoopCam
    from omniswarm_torch.swarm.loop_detector import LoopDetector

    t0 = time.perf_counter()
    cam = OmniLoopCam(params=FrontendParams(**IMAGE_FP), intrinsics=prep.intr,
                      baseline=BASELINE, device=card)
    with torch.no_grad():
        steps = [cam.on_fisheye_frames_batch(entries)
                 for entries in prep.steps]
    t_extract = time.perf_counter() - t0
    on_card = LoopDetector(0, FrontendParams(**IMAGE_FP), seed=0,
                           device=card)
    on_cpu = LoopDetector(0, FrontendParams(**IMAGE_FP), seed=0,
                          device="cpu")
    drawn = {}
    cpu_draw = on_cpu.tick_noise

    def cpu_noise(*key):
        drawn.clear()
        drawn[key] = cpu_draw(*key)
        return drawn[key]

    def card_noise(*key):
        return tuple(None if x is None else x.to(card)
                     for x in drawn.pop(key))

    on_cpu.tick_noise, on_card.tick_noise = cpu_noise, card_noise

    outs = {}
    for name, det in (("card", on_card), ("cpu", on_cpu)):
        def record(kfs, *tick, _walk=det._walk_tick, _name=name):
            outs[_name] = tick          # the tick's downloaded outputs
            return _walk(kfs, *tick)
        det._walk_tick = record

    def edges(results):
        return [[(c.edge.drone_a, c.edge.t_a, c.edge.drone_b, c.edge.t_b)
                 for c in per_kf] for per_kf in results]

    stats = collections.Counter()
    faults, inl_err, dpose_same, dpose_err, cpu_s = [], 0, 0.0, 0.0, 0.0
    for i, kfs in enumerate(steps):
        for batch in ([kfs[0]], kfs[1:]):
            t1 = time.perf_counter()
            want = on_cpu.on_keyframes_batch(batch)
            cpu_s += time.perf_counter() - t1
            got = on_card.on_keyframes_batch(batch)
            if edges(got) != edges(want):
                faults.append(f"step {i} Qb {len(batch)}: card "
                              f"{edges(got)} CPU {edges(want)}")
            for g, w in zip(sum(got, []), sum(want, [])):
                stats["loops"] += 1
                inl_err = max(inl_err, abs(g.num_inliers - w.num_inliers))
                dpose_err = max(dpose_err, float(np.abs(
                    np.asarray(g.edge.dpose) - np.asarray(w.edge.dpose)
                ).max()))
            # lane by lane: (src, slot, sim, idx_b, mask, n_match, n_valid,
            # dpose, n_inliers, inliers)
            (gs, gsl, _, gi, gm, _, _, gd, gk, gin) = outs["card"]
            (ws, wsl, _, wi, wm, _, _, wd, wk, win) = outs["cpu"]
            live = (gs >= 0) & (ws >= 0)
            stats["lanes"] += gs.size
            stats["retrieval_differs"] += int(
                ((gs != ws) | (live & (gsl != wsl))).sum())
            live &= gsl == wsl
            stats["live"] += int(live.sum())
            stats["matches_differ"] += int(
                (live & ((gm != wm).any(-1) | (gi != wi).any(-1))).sum())
            same_inl = (gin == win).all(-1)
            stats["inlier_sets_differ"] += int((live & ~same_inl).sum())
            stats["inlier_counts_differ"] += int((live & (gk != wk)).sum())
            stats["lane_inliers_max_diff"] = max(
                stats["lane_inliers_max_diff"],
                int(np.abs(gk - wk)[live].max(initial=0)))
            strong = live & same_inl & (np.minimum(gk, wk) >= 12)
            if strong.any():
                dpose_same = max(dpose_same, float(
                    np.abs(gd - wd)[strong].max()))
    out = dict(ticks=len(on_card.ticks), loops=stats["loops"],
               lanes=stats["lanes"], live_lanes=stats["live"],
               retrieval_differs=stats["retrieval_differs"],
               matches_differ=stats["matches_differ"],
               inlier_sets_differ=stats["inlier_sets_differ"],
               inlier_counts_differ=stats["inlier_counts_differ"],
               lane_inliers_max_diff=stats["lane_inliers_max_diff"],
               loop_inliers_max_diff=inl_err,
               loop_dpose_max_abs_err=dpose_err,
               same_inliers_dpose_max_abs_err=dpose_same,
               faults=len(faults), extract_s=t_extract, cpu_ticks_s=cpu_s,
               seconds=time.perf_counter() - t0)
    print("detector parity", json.dumps(out), flush=True)
    for f in faults:
        print(f"detector parity: {f}", flush=True)
    check(not faults, f"the card's detector accepts other loops than the "
          f"CPU's on {len(faults)} ticks")
    check(stats["loops"] > 0, "detector parity: no loop accepted")
    check(stats["retrieval_differs"] == 0 and stats["matches_differ"] == 0,
          "detector parity: retrieval or matching differs")
    check(stats["inlier_sets_differ"] <= DET_LANE_SHARE * stats["live"],
          f"detector parity: PnP inliers differ on "
          f"{stats['inlier_sets_differ']} of {stats['live']} lanes")
    check(inl_err <= DET_INLIER_SLACK and dpose_err <= DET_DPOSE_ATOL,
          f"detector parity: an accepted loop's inliers differ by {inl_err},"
          f" its dpose by {dpose_err}")
    return out


def image_demo_bars(name: str, res: dict, want: dict, flips: list) -> None:
    """An image demo run held to its anchors: every drone solved, the loop
    keys' flips, recall, precision before and after PCM, each drone's
    relative ATE against its anchor's and below raw VIO's."""
    check(res["all_solved"] and len(res["per_drone"]) == len(
        want["per_drone"]), f"{name}: a drone did not solve")
    check(len(flips) <= IMG_KEY_SHARE * len(want["loop_keys"]),
          f"{name}: {len(flips)} loop keys differ from the anchors")
    check(abs(res["loop_recall"] - want["loop_recall"]) <= IMG_RECALL_ATOL,
          f"{name} recall {res['loop_recall']} vs {want['loop_recall']}")
    check(res["loop_precision"] >= want["loop_precision"]
          - IMG_PRECISION_DROP, f"{name} precision "
          f"{res['loop_precision']} vs {want['loop_precision']}")
    check(res["loop_precision_post_pcm"] >= want["loop_precision_post_pcm"]
          - IMG_PCM_PRECISION_DROP, f"{name} post-PCM precision "
          f"{res['loop_precision_post_pcm']} vs "
          f"{want['loop_precision_post_pcm']}")
    for got, ref in zip(res["per_drone"], want["per_drone"]):
        check(got["relative_ate_cm"] <= ref["relative_ate_cm"]
              + IMG_ATE_SLACK_CM
              and got["relative_ate_cm"] < got["vio_relative_ate_cm"],
              f"{name} drone {got['drone']}: relative ATE "
              f"{got['relative_ate_cm']} cm (anchor {ref['relative_ate_cm']}"
              f", raw VIO {got['vio_relative_ate_cm']})")


def demo_numbers(res: dict, seconds: float, want: dict) -> dict:
    """A demo run's numbers for the "demo" line, each drone's cost and
    relative ATE beside its anchor's."""
    keep = ("loop_recall", "loop_precision", "loop_precision_post_pcm",
            "loops_unique", "loops_false", "loops_false_post_pcm",
            "loops_found", "loops_received", "revisit_opportunities",
            "all_solved", "frontend_views_per_s", "keyframe_latency_ms",
            "detector_ticks", "detector_tick_ms_median",
            "verify_lanes_per_tick", "k2_launches", "keyframe_steps")
    out = {k: res[k] for k in keep if k in res}
    out["per_drone"] = [
        dict({k: d.get(k) for k in ("drone", "cost", "relative_ate_cm",
                                    "vio_relative_ate_cm",
                                    "mean_abs_ate_cm")},
             anchor_cost=a["cost"],
             anchor_relative_ate_cm=a["relative_ate_cm"])
        for d, a in zip(res["per_drone"], want["per_drone"])]
    out["seconds"] = seconds
    return out


def demos_phase(prep) -> dict:
    """Phase 9a: the two demos, each run twice (bit-equal) and held to the
    JAX package's CPU anchors in DEMO_ANCHORS (the image demo's views
    ``prep``, the front-end path's render, for both runs), then the
    detector's card-vs-CPU parity."""
    from omniswarm_torch.demo_entry import (feature_demo_entry,
                                            image_demo_entry)
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1, retrieval_top1_ref)
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    out = {}
    want = DEMO_ANCHORS["feature"]
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        runs.append(feature_demo_entry(
            device="cuda",
            report_dir=f"{WORK_DIR}/demo_reports" if i == 0 else None))
        runs[-1]["seconds"] = time.perf_counter() - t0
    res = runs[0]
    flips = demo_flips(res, want)
    print(f"feature demo: {res['loops_unique']} unique loops, flips against "
          f"the anchors {flips}, bit-equal second run "
          f"{same_demo_run(res, runs[1])}", flush=True)
    check(same_demo_run(res, runs[1]), "two feature demo runs differ")
    check(res["all_solved"], "feature demo: a drone did not solve")
    check(len(flips) <= DEMO_KEY_SHARE * len(want["loop_keys"]),
          f"feature demo: {len(flips)} loop keys differ from the anchors")
    for got, ref in zip(res["per_drone"], want["per_drone"]):
        held(f"feature demo drone {got['drone']} cost", got["cost"],
             ref["cost"], rtol=DEMO_COST_RTOL)
        check(abs(got["relative_ate_cm"] - ref["relative_ate_cm"])
              <= DEMO_ATE_ATOL_CM, f"feature demo drone {got['drone']}: "
              f"relative ATE {got['relative_ate_cm']} cm, anchor "
              f"{ref['relative_ate_cm']} cm")
    out["feature"] = dict(demo_numbers(res, res["seconds"], want),
                          flips=flips)
    out["feature_reports"] = [
        dict(drone=d["drone"], report=d.get("report"),
             relative_ate_cm=d.get("relative_ate_cm"))
        for d in res["per_drone"]]

    want = DEMO_ANCHORS["image"]
    runs = []
    for i in range(2):
        grid_nms.launches = retrieval_top1.launches = 0
        fused_reduction_level.launches = 0
        grid_nms_ref.calls = retrieval_top1_ref.calls = 0
        fused_reduction_level_ref.calls = 0
        t0 = time.perf_counter()
        res = image_demo_entry(device="cuda", prep=prep)
        res["seconds"] = time.perf_counter() - t0
        res["k1_launches"] = fused_reduction_level.launches
        res["k3_launches"] = retrieval_top1.launches
        check(grid_nms_ref.calls == 0 and retrieval_top1_ref.calls == 0
              and fused_reduction_level_ref.calls == 0,
              "a plain kernel version ran on the demo path")
        check(res["k2_launches"] == res["keyframe_steps"] == FE_STEPS,
              f"image demo run {i}: K2 launched {res['k2_launches']} times "
              f"in {res['keyframe_steps']} keyframe steps")
        runs.append(res)
    res = runs[0]
    flips = demo_flips(res, want)
    print(f"image demo: {res['loops_unique']} unique loops "
          f"({len(want['loop_keys'])} in the anchors), flips {flips}, "
          f"bit-equal second run {same_demo_run(res, runs[1])}", flush=True)
    check(same_demo_run(res, runs[1]), "two image demo runs differ")
    image_demo_bars("image demo", res, want, flips)
    out["image"] = dict(demo_numbers(res, res["seconds"], want),
                        flips=flips, k1_launches=res["k1_launches"],
                        k3_launches=res["k3_launches"],
                        seconds_second_run=runs[1]["seconds"],
                        render_s=prep.render_s)
    out["detector_parity"] = detector_parity(prep)
    print("demo", json.dumps(out), flush=True)
    return out


def layout_calls(problems: dict) -> list:
    """The calls each rank of phase 10a makes, in order (launch.call_each),
    with their names."""
    par = "omniswarm_torch.parallel"
    window = f"{par}.sharded_window:lm_solve_bt_sharded"
    kw = dict(function_tolerance=0.0)
    w32, w1024, w256 = (problems[k] for k in ("w32", "w1024", "w256"))
    factors = f"{par}.sharded_solver:sharded_lm_solve"
    fleet = f"{par}.swarm_batch:solve_fleet"
    return [
        # one small solve of each layout first: the ranks start cold
        ("warm-up window F=32", window,
         dict(graph=w32[1], poses0=w32[0].vio, max_iterations=2, **kw)),
        ("warm-up factors F=16", factors,
         dict(graph=problems["f16"][1], poses0=problems["f16"][2],
              max_iterations=2, **kw)),
        ("warm-up fleet 4 x F=16", fleet,
         dict(graphs=problems["fleet16"][1],
              inits=[d.vio for d in problems["fleet16"][0]],
              max_iterations=2, **kw)),
        ("window F=1024", window, dict(graph=w1024[1], poses0=w1024[0].vio,
                                       max_iterations=50, **kw)),
        ("window F=256", window, dict(graph=w256[1], poses0=w256[0].vio,
                                      max_iterations=SOLVER_ITERS, **kw)),
        ("window F=256 again", window,
         dict(graph=w256[1], poses0=w256[0].vio,
              max_iterations=SOLVER_ITERS, **kw)),
        ("factors F=100", factors,
         dict(graph=problems["f100"][1], poses0=problems["f100"][2],
              max_iterations=SOLVER_ITERS, **kw)),
        ("fleet 8 x F=100", fleet,
         dict(graphs=problems["fleet"][1],
              inits=[d.vio for d in problems["fleet"][0]],
              max_iterations=SOLVER_ITERS, **kw)),
    ]


def layout_problems() -> dict:
    """Phase 10a's problems, numpy leaves (each rank is handed them
    whole)."""
    from omniswarm_torch import sim
    from omniswarm_torch.sim.pipeline import build_graph_from_sim
    from omniswarm_torch.solver.dense import dense_graph_from_sim

    def window(F, seed, **kw):
        data = sim.generate(sim.SimParams(num_drones=5, num_frames=F,
                                          seed=seed, **kw))
        return data, dense_graph_from_sim(data)

    def generic(F):
        data = sim.generate(sim.SimParams(num_drones=5, num_frames=F,
                                          seed=0))
        return (data,) + build_graph_from_sim(data, enable_detections=True)

    def fleet(lanes, F):
        datas = [sim.generate(sim.SimParams(num_drones=5, num_frames=F,
                                            seed=100 + k))
                 for k in range(lanes)]
        cap = max(8, max(len(d.loops) for d in datas))
        return datas, [dense_graph_from_sim(d, max_loops=cap) for d in datas]

    out = dict(w32=window(32, 3), w1024=window(1024, 0),
               w256=window(256, 2, loop_every=16), f16=generic(16),
               f100=generic(100), fleet16=fleet(4, 16), fleet=fleet(8, 100))
    cap = out["fleet"][1][0].loops.valid.shape[0]
    check(cap == PARALLEL_ANCHORS["fleet_100"]["loop_capacity"],
          f"fleet loop capacity {cap}")
    return out


def layout_numbers(name: str, world: int, backend: str, calls) -> dict:
    """One call of phase 10a (``calls``: its record on each rank): every
    rank's result equal, no kernel and no plain version run; ms per LM
    iteration (the slowest rank's) and collective calls and bytes per
    iteration, printed."""
    res = calls[0]["result"]
    for c in calls[1:]:
        check(np.array_equal(c["result"].cost, res.cost)
              and np.array_equal(c["result"].poses, res.poses),
              f"{name} at world {world}: the ranks' results differ")
    for c in calls:
        check(not any(c["kernels"].values()),
              f"{name} at world {world}: kernels ran {c['kernels']}")
    it = res.iterations
    per_it = {k: dict(calls=v["calls"] / it, bytes=v["bytes"] / it)
              for k, v in calls[0]["counts"].items()}
    out = dict(layout=name, world=world, backend=backend,
               cost=np.asarray(res.cost, np.float64).tolist(),
               iterations=it,
               ms_per_iteration=max(c["seconds"] for c in calls) * 1e3 / it,
               collectives=calls[0]["counts"],
               collectives_per_iteration=per_it)
    print(f"layouts world {world} ({backend}) {name}: cost {out['cost']} "
          f"iterations {it} {out['ms_per_iteration']:.2f} ms/iteration "
          f"collectives/iteration {json.dumps(per_it)}", flush=True)
    return out


def layouts_phase() -> dict:
    """Phase 10a: every layout at world 1 (NCCL) and world 4 (gloo, one
    card), held to single-process solves of this run and to the anchors."""
    import torch

    from omniswarm_torch.eval import metrics
    from omniswarm_torch.parallel.launch import call_each, run_ranks
    from omniswarm_torch.parallel.swarm_batch import solve_fleet
    from omniswarm_torch.solver.dense import lm_solve_bt
    from omniswarm_torch.solver.gauss_newton import lm_solve

    t0 = time.perf_counter()
    problems = layout_problems()
    names_calls = layout_calls(problems)
    calls = [c[1:] for c in names_calls]
    kw = dict(device="cuda", function_tolerance=0.0)
    w1024, w256, f100 = problems["w1024"], problems["w256"], problems["f100"]
    fleet_data, fleet_graphs = problems["fleet"]
    exact, exact_s = timed(lambda: lm_solve_bt(
        w1024[1], w1024[0].vio, max_iterations=50, exact_linear=True, **kw))
    generic = lm_solve(f100[1], f100[2], max_iterations=SOLVER_ITERS, **kw)
    singles = [float(lm_solve_bt(g, d.vio, max_iterations=SOLVER_ITERS,
                                 **kw).cost)
               for g, d in zip(fleet_graphs, fleet_data)]
    unsplit, unsplit_s = timed(lambda: solve_fleet(
        fleet_graphs, [d.vio for d in fleet_data],
        max_iterations=SOLVER_ITERS, **kw))
    print(f"layouts references: exact F=1024 cost {float(exact.cost)!r} "
          f"{exact_s * 1e3 / exact.iterations:.2f} ms/iteration; lm_solve "
          f"F=100 cost {float(generic.cost)!r}; fleet singles {singles}; "
          f"fleet unsplit {unsplit.cost.tolist()} "
          f"{unsplit_s * 1e3 / unsplit.iterations:.2f} ms/iteration",
          flush=True)
    fleet_anchor = PARALLEL_ANCHORS["fleet_100"]["cost"]
    for b, cost in enumerate(unsplit.cost.tolist()):
        held(f"unsplit fleet lane {b} vs its lm_solve_bt", cost, singles[b],
             rtol=LAYOUT_BAR)
        held(f"unsplit fleet lane {b}", cost, fleet_anchor[b],
             rtol=LAYOUT_BAR)

    out = dict(runs=[], references=dict(
        exact_1024=float(exact.cost), generic_100=float(generic.cost),
        fleet_singles=singles, fleet_unsplit=unsplit.cost.tolist(),
        exact_1024_ms_per_iteration=exact_s * 1e3 / exact.iterations,
        fleet_unsplit_ms_per_iteration=(unsplit_s * 1e3
                                        / unsplit.iterations)))
    launches = collections.Counter()
    for world, backend in LAYOUT_RUNS:
        t1 = time.perf_counter()
        ranks = run_ranks(call_each, world, backend=backend, device="cuda",
                          args=(calls,), timeout_s=600)
        print(f"layouts world {world} backend {backend}: {world} rank(s) on "
              f"{torch.cuda.device_count()} card(s), spawn and run "
              f"{time.perf_counter() - t1:.1f} s (ranks sharing a card "
              f"measure the layouts' overhead, not their scaling)",
              flush=True)
        nums = [layout_numbers(name, world, backend, [r[i] for r in ranks])
                for i, (name, *_) in enumerate(names_calls)]
        for r in ranks:
            for c in r:
                launches.update(c["kernels"])
        res = {n["layout"]: ranks[0][i]["result"]
               for i, n in enumerate(nums)}
        out["runs"] += nums

        w = res["window F=1024"]
        ate = metrics.mean_relative_ate(w.poses, w1024[0].gt)
        held(f"window F=1024 world {world} vs the exact lm_solve_bt",
             float(w.cost), float(exact.cost), rtol=LAYOUT_BAR)
        held(f"window F=1024 world {world}", float(w.cost),
             PARALLEL_ANCHORS["exact_1024"]["cost"], rtol=LAYOUT_BAR)
        check(ate < 0.1, f"window F=1024 world {world}: relative ATE {ate}")
        a, b = res["window F=256"], res["window F=256 again"]
        check_repeat(f"window F=256 world {world}", float(a.cost),
                     float(b.cost), a.poses, b.poses)
        held(f"window F=256 world {world}", float(a.cost),
             PARALLEL_ANCHORS["window_256"][f"world_{world}"],
             rtol=LAYOUT_BAR)
        f = res["factors F=100"]
        held(f"factors F=100 world {world}", float(f.cost),
             SOLVER_ANCHORS["generic_100"]["cost"], rtol=1e-3)
        held(f"factors F=100 world {world} vs lm_solve", float(f.cost),
             float(generic.cost), rtol=1e-3)
        dpose = float(np.abs(f.poses - generic.poses.cpu().numpy()).max())
        ate = metrics.mean_relative_ate(f.poses, f100[0].gt)
        check(dpose <= 5e-3 and ate < 0.08, f"factors F=100 world {world}: "
              f"poses {dpose} from lm_solve, relative ATE {ate}")
        fl = res["fleet 8 x F=100"]
        for b, cost in enumerate(np.asarray(fl.cost, np.float64)):
            held(f"fleet lane {b} world {world} vs its lm_solve_bt", cost,
                 singles[b], rtol=LAYOUT_BAR)
            held(f"fleet lane {b} world {world}", cost, fleet_anchor[b],
                 rtol=LAYOUT_BAR)
        ate = metrics.mean_relative_ate(fl.poses[0], fleet_data[0].gt)
        check(ate < 0.08, f"fleet lane 0 world {world}: relative ATE {ate}")
        counts = nums[-1]["collectives"]
        check(list(counts) == ["all_gather/output"]
              and counts["all_gather/output"]["calls"] == 1,
              f"fleet world {world}: collectives {counts}")
    out["launches"] = dict(launches)
    out["seconds"] = time.perf_counter() - t0
    print("layouts", json.dumps(out), flush=True)
    return out


def node_paced() -> dict:
    """Phase 11a (a), paced: the flight through NodeLoop on the worker
    thread and inline, bit-equal, beating raw VIO; K1 counted on the
    threaded run and checked at its new level shapes."""
    from omniswarm_torch.node_entry import paced_sessions
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    t0 = time.perf_counter()
    with k1_recording() as levels:
        paced = paced_sessions(device="cuda")
    check(fused_reduction_level_ref.calls == 0,
          "the plain level ran on the node path")
    for name in ("threaded", "inline"):
        run = paced[name]
        for s, w in zip(run["solves"], run["windows"]):
            if not s.get("solved"):
                continue
            print(f"node paced {name} solve t={s['t']}: {len(w)} keyframes "
                  f"cost {s['cost']!r} iterations {s['iterations']} "
                  f"finish_init {s['finish_init']}", flush=True)
        print(f"node paced {name}: {run['seconds']:.1f} s, relative ATE "
              f"{run['relative_ate']!r} (raw VIO {run['vio_relative_ate']!r})"
              f", {run['predictions']} predictions, K1 "
              f"{run['k1_launches']}", flush=True)
    thr = paced["threaded"]
    check(paced["bit_equal"], "the threaded and inline node sessions differ")
    check(len(thr["solves"]) == 15 and all(
        s.get("solved") for s in thr["solves"][1:]),
        f"node paced: solves {thr['solves']}")
    check(thr["relative_ate"] is not None
          and thr["relative_ate"] < thr["vio_relative_ate"],
          f"node paced: relative ATE {thr['relative_ate']} against raw "
          f"VIO's {thr['vio_relative_ate']}")
    check(thr["last_prediction_drones"] == NODE_DRONES,
          f"node paced: the last prediction has "
          f"{thr['last_prediction_drones']} drones")
    print(f"node paced: bit-equal {paced['bit_equal']}, K1 launches "
          f"{thr['k1_launches']} on the threaded run at {dict(levels)}; "
          f"threaded cadence {json.dumps(thr['cadence'])}", flush=True)
    return dict(
        bit_equal=paced["bit_equal"], k1_launches=thr["k1_launches"],
        k1_launches_both=fused_reduction_level.launches,
        k1_levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
        k1_checked=estimator_checks_k1(levels),
        relative_ate=thr["relative_ate"],
        vio_relative_ate=thr["vio_relative_ate"],
        cadence_threaded=thr["cadence"],
        costs=[s.get("cost") for s in thr["solves"]],
        finish_init=[s.get("finish_init") for s in thr["solves"]],
        seconds_threaded=thr["seconds"],
        seconds_inline=paced["inline"]["seconds"],
        seconds=time.perf_counter() - t0)


def node_free() -> dict:
    """Phase 11a (a), free-running: run_node.main in a subprocess at the
    config's own cadence."""
    from omniswarm_torch import sim
    from omniswarm_torch.node_entry import (free_running,
                                            free_running_summary,
                                            frame_lines, node_flight)

    data = node_flight(sim)
    final_t = float(data.times[-1])
    run = free_running(frame_lines(data), fps=NODE_FPS)
    out = free_running_summary(run, final_t)
    print("node free-running", json.dumps(out), flush=True)
    check(out["returncode"] == 0,
          f"node free-running: exit {out['returncode']}: "
          f"{run['stderr_tail']}")
    check(out["solved"] >= NODE_MIN_SOLVED,
          f"node free-running: {out['solved']} solves")
    check(out["last_solved_t"] >= NODE_FINAL_SHARE * final_t,
          f"node free-running: the last solve at t={out['last_solved_t']}"
          f" of {final_t}")
    check(out["last_prediction_drones"] == NODE_DRONES,
          f"node free-running: the last prediction has "
          f"{out['last_prediction_drones']} drones")
    return out


def node_processes() -> dict:
    """Phase 11a (b): two drone processes over loopback multicast."""
    from omniswarm_torch.node_entry import process_swarm

    out = process_swarm(f"{WORK_DIR}/processes", port=NODE_MP_PORT)
    for row in out["processes"]:
        print(f"node process {row['drone']}: exit {row['returncode']} "
              f"solved {row['solved']} relative ATE {row['relative_ate']!r}"
              f" loops found/received {row.get('loops_found')}/"
              f"{row.get('loops_received')}", flush=True)
        check(row["returncode"] == 0, f"drone process {row['drone']}: "
              f"{row['tail']}")
        check(not row["solved"] or (row["relative_ate"] is not None
                                    and row["relative_ate"] < NODE_MP_ATE),
              f"drone process {row['drone']}: relative ATE "
              f"{row['relative_ate']}")
    rows = out["processes"]
    check(any(r["solved"] for r in rows), "no drone process solved")
    check(sum(r["loops_found"] + r["loops_received"] for r in rows
              if r["solved"]) > 0, "no loop edge crossed the processes")
    for row in rows:
        row.pop("tail")
    return out


def node_reports(reports: list) -> list:
    """Phase 11a (c): the feature demo's per-drone reports of 9a."""
    rows = []
    for r in reports:
        path = f"{r['report']}/summary.json" if r["report"] else None
        check(path is not None, f"feature demo drone {r['drone']}: no report")
        with open(path) as f:
            summary = json.load(f)
        got = summary["mean_relative_ate"] * 100
        check(abs(got - r["relative_ate_cm"])
              <= REPORT_ATE_RTOL * abs(r["relative_ate_cm"]),
              f"{path}: relative ATE {got} cm, the demo's "
              f"{r['relative_ate_cm']} cm")
        rows.append(dict(drone=r["drone"], report=path, relative_ate_cm=got))
    print(f"node reports: {len(rows)} summaries agree with the demo's ATE",
          flush=True)
    return rows


def node_phase(reports: list) -> dict:
    """Phase 11a: the production node (see the docstring)."""
    from omniswarm_torch.ops.frontend_kernels import (grid_nms,
                                                      retrieval_top1)

    t0 = time.perf_counter()
    grid_nms.launches = retrieval_top1.launches = 0
    out = dict(paced=node_paced())
    out["k2_launches"], out["k3_launches"] = (grid_nms.launches,
                                              retrieval_top1.launches)
    t1 = time.perf_counter()
    out["free_running"] = node_free()
    out["free_running"]["phase_seconds"] = time.perf_counter() - t1
    out["processes"] = node_processes()
    out["reports"] = node_reports(reports)
    out["seconds"] = time.perf_counter() - t0
    print("node", json.dumps(out), flush=True)
    return out


def train_flips(name: str, got: dict, want: dict, keys) -> int:
    """The largest count difference of a metric row against its anchor."""
    flips = max(abs(got[k] - want[k]) for k in keys)
    print(f"train (a) {name}: {json.dumps({k: got[k] for k in keys})} "
          f"anchor {json.dumps({k: want[k] for k in keys})} flips {flips} "
          f"(allowance {TRAIN_FLIPS})", flush=True)
    check(flips <= TRAIN_FLIPS, f"train (a) {name}: {flips} flips")
    return flips


def train_bundled_metrics() -> dict:
    """12a (a): the bundled checkpoints' metrics under highp against their
    JAX-CPU anchors, at most TRAIN_FLIPS counts apart."""
    from omniswarm_torch import train_entry as te
    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.models import train_netvlad as tnv
    from omniswarm_torch.models import train_superpoint as tsp
    from omniswarm_torch.models.superpoint import WEIGHTS_DIR

    want = TRAIN_ANCHORS["superpoint"]
    out = {}
    with highp():
        det = tsp.detection_metrics(
            te.read_superpoint(WEIGHTS_DIR / "superpoint_synthetic.npz"),
            n_eval=32)
        out["detection"] = dict(det, flips=train_flips(
            "detection superpoint_synthetic", det, want["detection"],
            ("tp", "fp", "fn")))
        photo = te.read_superpoint(WEIGHTS_DIR / "superpoint_photo_v2.npz")
        for row, kw in te.MATCHING_ROWS.items():
            m = tsp.matching_metrics(photo, n_eval=24, **kw)
            m["correct"] = round(m["match_precision"] * m["matches"])
            out[f"matching_{row}"] = dict(m, flips=train_flips(
                f"matching superpoint_photo_v2 {row}", m,
                want["matching"][row], ("matches", "correct")))
        hard = tnv.retrieval_metrics(
            te.read_netvlad(WEIGHTS_DIR / "netvlad_v2_revisit.npz"),
            n_places=96, max_rot=0.5, noise=0.06, scale=(0.8, 1.25),
            revisit_offset=0.35, encoder_version=2)
        hard["correct"] = round(hard["recall_at_1"] * 96)
        out["hard_revisit_96"] = dict(hard, flips=train_flips(
            "retrieval netvlad_v2_revisit hard 96-way", hard,
            TRAIN_ANCHORS["netvlad"]["hard_revisit_96"], ("correct",)))
    return out


def continued_training(syn: dict, deterministic: bool):
    """20 steps of train_detector, then 20 of train_descriptors, each from
    ``syn`` (seed 0, batch 8, 64 x 96), under highp; cuDNN deterministic
    or not. Returns (detector history, joint history, final params)."""
    import torch

    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.models import train_superpoint as tsp

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    kw = dict(steps=20, batch=8, h=64, w=96, seed=0, log_every=1,
              params=syn)
    try:
        with highp():
            _, hd = tsp.train_detector(**kw)
            params, hj = tsp.train_descriptors(**kw)
    finally:
        torch.backends.cudnn.deterministic = saved
    return hd, hj, params


def train_continued() -> dict:
    """12a (b): continued training held to the anchor loss histories, two
    deterministic runs bit-equal, the non-deterministic spread printed."""
    import torch

    from omniswarm_torch import train_entry as te
    from omniswarm_torch.models.superpoint import WEIGHTS_DIR, net_state

    syn = net_state(te.read_superpoint(
        WEIGHTS_DIR / "superpoint_synthetic.npz"))
    runs = [continued_training(syn, True) for _ in range(2)]
    free = continued_training(syn, False)
    a, b = runs
    same = a[:2] == b[:2] and all(torch.equal(a[2][k], b[2][k])
                                  for k in a[2])
    check(same, "two deterministic continued-training runs differ")
    want = TRAIN_ANCHORS["superpoint"]
    out = {"bit_equal_deterministic": same}
    tol = [next(r for n, r in TRAIN_LOSS_RTOL if i < n) for i in range(20)]
    for name, got, ref, spread in (
            ("detector", a[0], want["detector_losses"], free[0]),
            ("joint", a[1], want["joint_losses"], free[1])):
        rel = [abs(g[1] - r[1]) / abs(r[1]) for g, r in zip(got, ref)]
        free_rel = [abs(f[1] - g[1]) / abs(g[1]) for f, g in zip(spread, got)]
        print(f"train (b) {name}: losses {[g[1] for g in got]}; anchor "
              f"{[r[1] for r in ref]}; rel {[f'{x:.1e}' for x in rel]} "
              f"(tolerance {TRAIN_LOSS_RTOL}); without deterministic cuDNN "
              f"rel {[f'{x:.1e}' for x in free_rel]}", flush=True)
        out[name] = dict(
            last_loss=got[-1][1], rel=rel, ok=len(got) == len(ref) == 20
            and all(x <= t for x, t in zip(rel, tol)),
            nondeterministic_spread=max(free_rel), free_rel=free_rel)
    for name in ("detector", "joint"):
        check(out[name]["ok"], f"train (b) {name}: losses "
              f"{out[name]['rel']} from their anchors")
    return out


def band(values, key: str):
    """The JAX seeds' [min, max] of ``key`` widened by half its width, and
    by at least the metric's resolution."""
    v = [r[key] for r in values]
    pad = max((max(v) - min(v)) / 2, TRAIN_RESOLUTION[key])
    return min(v) - pad, max(v) + pad


def train_from_scratch() -> dict:
    """12a (c), (d): the detector through ``superpoint_main`` (300 steps,
    batch 8, Flax's init, PCA fitted on 32 images) against the reference
    test's bars; ``train_netvlad`` at the tool's width against the band of
    the JAX seeds. At PyTorch's default precision (TF32 convolutions), as
    a user's training runs: both are held to bars, not to bits."""
    from omniswarm_torch import train_entry as te
    from omniswarm_torch.models import train_netvlad as tnv

    t0 = time.perf_counter()
    sp = te.superpoint_main([
        "--steps", str(TRAIN_SCRATCH_STEPS), "--batch", "8",
        "--fit-pca", "32", "--out", f"{WORK_DIR}/train/magicpoint.npz"])
    first, last = sp["history_detector"][0][1], sp["history_detector"][-1][1]
    det = sp["detection"]
    bars = TRAIN_SCRATCH_BARS
    out = {"detector": dict(first_loss=first, last_loss=last,
                            detection=det, seconds=time.perf_counter() - t0,
                            out=sp["out"], pca_explained=sp["pca_explained"],
                            params=sp["params"])}
    print(f"train (c) detector from scratch: loss {first!r} -> {last!r}, "
          f"{json.dumps(det)}, {out['detector']['seconds']:.1f} s",
          flush=True)
    check(last < bars["loss_ratio"] * first, "train (c): the loss fell from "
          f"{first} to {last} only")
    check(det["recall"] > bars["recall"] and det["precision"] >
          bars["precision"], f"train (c): detection {det}")

    t0 = time.perf_counter()
    nv = TRAIN_ANCHORS["netvlad"]
    runs = []
    for seed in TRAIN_NETVLAD_SEEDS:
        path = f"{WORK_DIR}/train/netvlad_{seed}.npz"
        params, hist = tnv.train_netvlad(
            steps=nv["steps"], seed=seed, log_every=1,
            save_every=nv["steps"] // 2, save_path=path)
        losses = [loss for _, loss in hist]
        easy = tnv.retrieval_metrics(params, encoder_version=1)
        runs.append(dict(seed=seed, first_loss=losses[0],
                         last_loss=losses[-1],
                         final_loss=sum(losses[-nv["final_window"]:])
                         / nv["final_window"],
                         easy_recall=easy["recall_at_1"], out=path))
        print(f"train (d) netvlad seed {seed}: {json.dumps(runs[-1])}",
              flush=True)
        if seed == TRAIN_NETVLAD_SEEDS[0]:
            first = dict(out=path, params=params)
    out["netvlad"] = dict(runs=runs, seconds=time.perf_counter() - t0,
                          **first)
    for key in ("final_loss", "easy_recall"):
        mean = sum(r[key] for r in runs) / len(runs)
        lo, hi = band(nv["runs"], key)
        out["netvlad"][key] = mean
        print(f"train (d) netvlad mean {key} {mean!r} band [{lo!r}, {hi!r}] "
              f"(JAX seeds {[r[key] for r in nv['runs']]})", flush=True)
        check(lo <= mean <= hi, f"train (d): mean {key} {mean} outside "
              f"[{lo}, {hi}]")
    print(f"train (d) netvlad: {len(runs)} x {nv['steps']} steps "
          f"{out['netvlad']['seconds']:.1f} s", flush=True)
    return out


def train_reload(scratch: dict) -> dict:
    """12a (e): the checkpoints written in (c) and (d) load into
    ``pretrained_extractor`` / ``pretrained_global_extractor`` and give the
    forward of the in-memory weights rounded to f16."""
    import torch

    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.models import train_netvlad as tnv
    from omniswarm_torch.models import train_superpoint as tsp
    from omniswarm_torch.models.netvlad import pretrained_global_extractor
    from omniswarm_torch.models.superpoint import pretrained_extractor

    f16 = lambda state: {k: v.half().float() for k, v in state.items()}
    rng = np.random.default_rng(11)
    imgs, _ = tsp.make_batch(rng, 4, 64, 96)
    x = tsp.to_images(imgs, "cuda")
    views = tsp.to_images(tnv.PlacePool(2, seed=12).batch(2), "cuda")
    sp_params = scratch["detector"]["params"]
    out = {}
    with highp(), torch.no_grad():
        ext = pretrained_extractor("cuda", path=scratch["detector"]["out"])
        mem = tsp.load_superpoint(sp_params, 0, "cuda")
        rounded = tsp.load_superpoint(f16(sp_params), 0, "cuda")
        got, exact, want = ext.net(x), mem(x), rounded(x)
        out["superpoint"] = dict(
            heat_err=float((got[0] - want[0]).abs().max()),
            desc_err=float((got[1] - want[1]).abs().max()),
            heat_err_f32=float((got[0] - exact[0]).abs().max()),
            pca_equal=bool(torch.equal(
                ext.pca_components.cpu(),
                sp_params["pca_components"].half().float())))
        gext = pretrained_global_extractor("cuda",
                                           path=scratch["netvlad"]["out"])
        nv_params = scratch["netvlad"]["params"]
        got = gext(views)
        want = tnv.load_netvlad(f16(nv_params), 1, 0, "cuda")(views)
        exact = tnv.load_netvlad(nv_params, 1, 0, "cuda")(views)
        out["netvlad"] = dict(desc_err=float((got - want).abs().max()),
                              desc_err_f32=float((got - exact).abs().max()))
    print(f"train (e) reload {json.dumps(out)} (tolerance "
          f"{TRAIN_RELOAD_ATOL} against the f16-rounded weights)", flush=True)
    check(max(out["superpoint"]["heat_err"], out["superpoint"]["desc_err"],
              out["netvlad"]["desc_err"]) <= TRAIN_RELOAD_ATOL
          and out["superpoint"]["pca_equal"], f"train (e): {out}")
    return out


def train_step_times(card: str) -> list:
    """12a (f): ms per step, host render apart from the device step (upload,
    forward, backward, Adam; synchronised), after 2 warm-up steps, at the
    tools' batch sizes and PyTorch's default precision."""
    import torch

    from omniswarm_torch.models import train_netvlad as tnv
    from omniswarm_torch.models import train_superpoint as tsp

    def timed(fn):
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    rows = []
    model = tsp.load_superpoint(None, 0, "cuda")
    opt = tsp.adam(model, 1e-3)
    rng = np.random.default_rng(0)

    def upload(imgs, labels):
        return (tsp.to_images(imgs, "cuda"),
                torch.from_numpy(labels).long().cuda())

    def detector(batch_fn, ha):
        def render():
            imgs, labels = batch_fn(rng, 32, 64, 96)
            if ha:
                labels = tsp.homographic_adaptation_labels(model, imgs, rng)
            return imgs, labels
        return render, lambda b: tsp.detector_update(model, opt, *upload(*b))

    def joint(batch_fn, render_fn, scale):
        def render():
            return batch_fn(rng, 16, 64, 96), tsp.make_warped_pairs(
                rng, 16, 64, 96, max_rot=0.55, scale=scale,
                render_fn=render_fn)

        def step(b):
            (imgs, labels), (ia, ib, T) = b
            return tsp.joint_update(
                model, opt, *upload(imgs, labels), tsp.to_images(ia, "cuda"),
                tsp.to_images(ib, "cuda"), torch.from_numpy(T).cuda())
        return render, step

    cases = {
        "train_detector magicpoint batch 32": detector(tsp.make_batch, False),
        "train_detector photometric batch 32 (HA labels)": detector(
            tsp.make_batch_textured, True),
        "train_descriptors magicpoint batch 16": joint(
            tsp.make_batch, None, (1.0, 1.0)),
        "train_descriptors photometric batch 16": joint(
            tsp.make_batch_textured, tsp.render_mixed, (0.8, 1.25)),
    }
    pool = tnv.PlacePool(256, seed=0)
    places = torch.from_numpy(np.stack(pool.places)).cuda()
    nvmodel = tnv.load_netvlad(None, 1, 0, "cuda")
    nvopt = tsp.adam(nvmodel, 3e-4)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def nv_render():
        idx = torch.from_numpy(rng.choice(256, 16, replace=False)).cuda()
        return torch.cat([tnv.device_render_views(
            places, idx, tnv.view_draws(16, 96, 160, gen), 96, 160)
            for _ in range(2)])
    cases["train_netvlad 16 places (render on the card)"] = (
        nv_render, lambda v: tnv.netvlad_update(nvmodel, nvopt, v))
    for name, (render, step) in cases.items():
        times = []
        for i in range(TRAIN_TIMED_STEPS + 2):
            b, r_ms = timed(render)
            _, s_ms = timed(lambda: step(b))
            if i >= 2:
                times.append((r_ms, s_ms))
        r_ms = sum(t[0] for t in times) / len(times)
        s_ms = sum(t[1] for t in times) / len(times)
        rows.append(dict(name=name, render_ms=r_ms, step_ms=s_ms,
                         total_ms=r_ms + s_ms))
        print(f"train (f) {name}: render {r_ms:.2f} ms + device step "
              f"{s_ms:.2f} ms a step ({card})", flush=True)
    return rows


def training_phase(card: str) -> dict:
    """Phase 12a: the training path (see the docstring)."""
    import torch

    from omniswarm_torch import kernels
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1, retrieval_top1_ref)
    from omniswarm_torch.models import train_superpoint as tsp
    from omniswarm_torch.solver.fused_level import fused_reduction_level

    t0 = time.perf_counter()
    out = {}
    with k1_recording() as levels, k2_recording() as shapes:
        out["bundled"] = train_bundled_metrics()
        out["continued"] = train_continued()
        scratch = train_from_scratch()
        out["reload"] = train_reload(scratch)
    out["launches"] = dict(k1=fused_reduction_level.launches,
                           k2=grid_nms.launches, k3=retrieval_top1.launches)
    out["k2_shapes"] = [[*s, n] for s, n in sorted(shapes.items())]
    check(grid_nms_ref.calls == 0 and retrieval_top1_ref.calls == 0,
          "a plain kernel version ran on the training path")
    check(out["launches"]["k1"] == 0 and out["launches"]["k3"] == 0
          and not levels and out["launches"]["k2"] > 0,
          f"training path launches {out['launches']}")
    check(set(shapes) == set(K2_TRAIN_SHAPES),
          f"K2 on the training path at {dict(shapes)}")
    # K2 against its plain version at the path's shapes, on heat maps of
    # the trained detector
    checked = []
    with torch.no_grad():
        net = tsp.load_superpoint(scratch["detector"]["params"], 0, "cuda")
        for B, H, W in K2_TRAIN_SHAPES:
            imgs, _ = tsp.make_batch(np.random.default_rng(B), B, H, W)
            heat = net(tsp.to_images(imgs, "cuda"))[0].contiguous()
            got = kernels.grid_nms(heat, 4)
            ref = grid_nms_ref(heat, 4)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"K2 disagrees on the training "
                  f"path's heat at {(B, H, W)}")
            checked.append(dict(shape=[B, H, W], r=4, kind="train_heat",
                                aligned=True, kept=int((got > 0).sum()),
                                max_abs_err=float((got - ref).abs().max())))
    out["k2_checked"] = checked
    for v in scratch.values():
        v.pop("params", None)
    out["scratch"] = scratch
    out["path_seconds"] = time.perf_counter() - t0
    out["step_times"] = train_step_times(card)
    out["card"] = card
    out["seconds"] = time.perf_counter() - t0
    print("training", json.dumps(out), flush=True)
    return out


def tier10_solve(name: str, anchor: dict, D: int, F: int, seed: int,
                 iters: int, k1: bool) -> dict:
    """One solve of phase 13a through entry(), twice (bit-equal), held to
    its JAX-CPU anchor: cost within 1%, the anchor's iteration count, cost
    below the initial one, relative ATE below raw VIO's; K1's launches at
    SOLVE_LEVELS's shapes for (F, D) once an iteration if ``k1``, else
    none. Host seconds: the synchronised solve, and the rest of entry()
    (simulation, graph build, scoring) as ``setup_s``."""
    from omniswarm_torch.entry import entry
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    def run():
        return entry(device="cuda", num_frames=F, num_drones=D, seed=seed,
                     max_iterations=iters)

    t0 = time.perf_counter()
    with k1_recording() as levels:
        res = run()
    wall = time.perf_counter() - t0
    if k1:
        launches = check_k1_levels(F, levels, res.iterations, D)
    else:
        launches = fused_reduction_level.launches
        check(launches == 0 and not levels
              and fused_reduction_level_ref.calls == 0,
              f"{name}: K1 ran ({launches} launches) on a path without it")
    again = run()
    check_repeat(name, res.cost, again.cost, res.poses, again.poses)
    out = dict(path=name, D=D, F=F, seed=seed, loops=res.num_loops,
               cost=res.cost, anchor_cost=anchor["cost"],
               initial_cost=res.initial_cost, iterations=res.iterations,
               relative_ate=res.relative_ate,
               anchor_relative_ate=anchor["relative_ate"],
               vio_relative_ate=res.vio_relative_ate, launches=launches,
               levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
               ms_per_iteration=res.solve_s * 1e3 / res.iterations,
               repeat_ms_per_iteration=again.solve_s * 1e3
               / again.iterations,
               solve_s=res.solve_s, setup_s=wall - res.solve_s)
    print("tier-10 solve", json.dumps(out), flush=True)
    held(f"{name} cost", res.cost, anchor["cost"])
    check(res.iterations == anchor["iterations"],
          f"{name}: {res.iterations} iterations, the anchor "
          f"{anchor['iterations']}")
    check(math.isfinite(res.cost) and res.cost < res.initial_cost,
          f"{name}: cost {res.cost} not below {res.initial_cost}")
    check(res.relative_ate < res.vio_relative_ate,
          f"{name}: relative ATE {res.relative_ate} not below raw VIO's "
          f"{res.vio_relative_ate}")
    return out


def tier10_demo() -> dict:
    """Phase 13a (c): the 10 x 30 image demo through the command line's
    own function, held to DEMO_ANCHORS["image_d10"] at phase 9a's bars."""
    from omniswarm_torch import demo_entry
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1, retrieval_top1_ref)
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    want = DEMO_ANCHORS["image_d10"]
    path = f"{WORK_DIR}/image_demo_d10.json"
    t0 = time.perf_counter()
    with k1_recording() as levels, k2_recording() as shapes:
        res = demo_entry.main(["image", "--drones", "10", "--frames", "30",
                               "--out", path])
    seconds = time.perf_counter() - t0
    launches = dict(k1=fused_reduction_level.launches, k2=grid_nms.launches,
                    k3=retrieval_top1.launches)
    flips = demo_flips(res, want)
    print(f"image demo D=10: {res['loops_unique']} unique loops "
          f"({len(want['loop_keys'])} in the anchors), flips {flips}, K2 at "
          f"{dict(shapes)}", flush=True)
    check(grid_nms_ref.calls == 0 and retrieval_top1_ref.calls == 0
          and fused_reduction_level_ref.calls == 0,
          "a plain kernel version ran on the 10-drone demo's path")
    check(dict(shapes) == {K2_D10_SHAPE: D10_DEMO_STEPS}
          and launches["k2"] == res["k2_launches"] == res["keyframe_steps"]
          == D10_DEMO_STEPS, f"image demo D=10: K2 at {dict(shapes)}, "
          f"{launches['k2']} launches in {res['keyframe_steps']} steps")
    check(launches["k1"] == 0 and not levels and launches["k3"] == 0,
          f"image demo D=10 launches {launches}")
    with open(path) as f:
        check(json.load(f)["drones"] == 10, f"{path} is not the run's")
    image_demo_bars("image demo D=10", res, want, flips)
    print(f"image demo D=10 host seconds: render {res['render_s']:.1f}, "
          f"frame loop {res['session_s']:.1f} (detector ticks "
          f"{res['detector_ticks']} x median "
          f"{res['detector_tick_ms_median']:.2f} ms), final solves "
          f"{res['solve_s']:.1f}, of {seconds:.1f}", flush=True)
    return dict(demo_numbers(res, seconds, want), flips=flips,
                launches=launches, render_s=res["render_s"],
                session_s=res["session_s"], solve_s=res["solve_s"])


def tier10_phase() -> dict:
    """Phase 13a: the 10-drone tier and the loop-dense window (see the
    docstring)."""
    t0 = time.perf_counter()
    out = {}
    out["d10_100"] = tier10_solve("d10_100", SOLVER_ANCHORS["d10_100"], 10,
                                  100, 3, 50, k1=False)
    check(out["d10_100"]["relative_ate"] < D10_ATE_BAR,
          f"d10_100 relative ATE {out['d10_100']['relative_ate']} >= "
          f"{D10_ATE_BAR}")
    out["d10_1024"] = tier10_solve("d10_1024", SOLVER_ANCHORS["d10_1024"],
                                   10, 1024, 0, 20, k1=True)
    out["dense"] = dense_tool()
    out["solve_seconds"] = time.perf_counter() - t0
    out["demo"] = tier10_demo()
    out["seconds"] = time.perf_counter() - t0
    print("tier10", json.dumps(out), flush=True)
    return out


def bf16_parity() -> dict:
    """Phase 14a (a): the bundled SuperPoint and both NetVLAD encoders in
    bf16 against f32 (highp) on the card, at tests/test_bf16_frontend.py's
    bars, on BF16_BATCH render_shapes images at 400 x 208."""
    import torch

    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.models.netvlad import pretrained_global_extractor
    from omniswarm_torch.models.superpoint import (WEIGHTS_DIR,
                                                   pretrained_extractor)
    from omniswarm_torch.sim.image_world import render_shapes

    H, W = BF16_HW
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(np.stack([render_shapes(rng, H, W, n_shapes=8)[0]
                                      for _ in range(BF16_BATCH)]))
    x = imgs[:, None].cuda()
    bars, out = BF16_BARS, {}
    with highp(), torch.no_grad():
        sp = {dt: pretrained_extractor("cuda", dtype=dt)
              for dt in (torch.float32, torch.bfloat16)}
        (h32, d32), (h16, d16) = (sp[dt].net(x) for dt in sp)
        o32, o16 = (tuple(v.cpu().numpy() for v in sp[dt](x)) for dt in sp)
        out["heat_max_abs"] = float((h32 - h16).abs().max())
        out["desc_cos_min"] = float((d32 * d16).sum(-1).min())
        shares = []
        for b in range(BF16_BATCH):
            a, c = o32[0][b][o32[3][b]], o16[0][b][o16[3][b]]
            check(len(a) > 0 and len(c) > 0,
                  f"bf16 parity: image {b} has {len(a)} f32 and {len(c)} "
                  f"bf16 keypoints")
            d = np.linalg.norm(a[:, None] - c[None], axis=-1)
            shares.append(float((d.min(axis=1) < bars["kp_px"]).mean()))
        out["kp_matched_min"] = min(shares)
        for name in ("netvlad_v2_revisit.npz", "netvlad_synthetic.npz"):
            g32, g16 = (pretrained_global_extractor(
                "cuda", path=WEIGHTS_DIR / name, dtype=dt)(x)
                for dt in (torch.float32, torch.bfloat16))
            out[name] = dict(
                cos_min=float((g32 * g16).sum(-1).min()),
                pairwise_max=float((g32 @ g32.T - g16 @ g16.T).abs().max()))
    print("bf16 parity", json.dumps(out), flush=True)
    check(out["heat_max_abs"] < bars["heat"]
          and out["desc_cos_min"] > bars["desc_cos"]
          and out["kp_matched_min"] > bars["kp_matched"]
          and all(out[n]["cos_min"] > bars["global_cos"]
                  and out[n]["pairwise_max"] < bars["pairwise"]
                  for n in ("netvlad_v2_revisit.npz",
                            "netvlad_synthetic.npz")),
          f"bf16 trunks outside tests/test_bf16_frontend.py's bars: {out}")
    return out


def bench_phase() -> dict:
    """Phase 14a (b): the CPU baseline (CPU_BASELINE_ITERS iterations,
    CPU_BASELINE_REPS repetition, warm_up=False), then
    python -m omniswarm_torch.bench's run at its own sizes with BENCH_REPS,
    printed as one "bench" line: every key of BENCH_r05.json's parsed, no
    *_error key, kf1024_fused_cost_delta within the 2e-3 bar, K1 and K2
    launched in the rows that run them, no plain version; each K1 (m, t)
    outside SOLVE_LEVELS is checked after the run, and K2 ran only at
    K2_BENCH_SHAPES."""
    from omniswarm_torch import bench, cpu_baseline
    from omniswarm_torch.ops.frontend_kernels import (grid_nms, grid_nms_ref,
                                                      retrieval_top1)
    from omniswarm_torch.solver.fused_level import fused_reduction_level_ref

    t0 = time.perf_counter()
    base = cpu_baseline.measure(CPU_BASELINE_ITERS, reps=CPU_BASELINE_REPS,
                                warm_up=False)
    base_path = f"{WORK_DIR}/baseline_cpu.json"
    os.makedirs(WORK_DIR, exist_ok=True)
    with open(base_path, "w") as f:
        json.dump(base, f)
    print("cpu baseline", json.dumps(base), flush=True)
    base_s = time.perf_counter() - t0
    with k1_recording() as levels, k2_recording() as shapes:
        line = bench.run("cuda", base_path,
                         sizes=bench.Sizes(**BENCH_REPS))
    print("bench", json.dumps(line), flush=True)
    with open("BENCH_r05.json") as f:
        want = set(json.load(f)["parsed"])
    launches = line["kernel_launches"]
    check(want <= set(line), f"bench lacks {sorted(want - set(line))}")
    check(not [k for k in line if k.endswith("_error")], "bench *_error key")
    check(line["kf1024_fused_cost_delta"] <= bench.FUSED_COST_BAR,
          f"kf1024 fused vs unfused {line['kf1024_fused_cost_delta']}")
    check(fused_reduction_level_ref.calls == 0 and grid_nms_ref.calls == 0,
          "a plain kernel version ran in the bench")
    check(all(launches[r]["k1"] > 0 for r in ("headline", "kf1024",
                                               "dense_loops", "efficiency"))
          and launches["frontend"]["k2"] > 0
          and launches["frontend"]["k2"] == grid_nms.launches,
          f"bench launches {launches}")
    check(set(shapes) <= set(K2_BENCH_SHAPES),
          f"K2 ran at {dict(shapes)}, not only at {K2_BENCH_SHAPES}")
    k3 = retrieval_top1.launches
    check(k3 == 0, f"K3 launched {k3} times in the bench")
    k1_checked = estimator_checks_k1(levels)
    return dict(line=line, launches=launches, k3_launches=k3,
                k1_checked=k1_checked,
                k1_levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
                k2_shapes=[[*k, n] for k, n in sorted(shapes.items())],
                baseline=base, baseline_s=base_s,
                seconds=time.perf_counter() - t0)


def online_phase() -> dict:
    """Phase 14a (c): python -m omniswarm_torch.online_window's session at
    1,024 keyframes and 2,000 loops with ONLINE_SOLVES live solves (the
    fast build, never a fallback), each anchored solve held to
    ONLINE_ANCHORS by online_window.held_to; K1 launched, its new level
    shapes checked against the plain version after the run."""
    from omniswarm_torch import online_window
    from omniswarm_torch.ops.frontend_kernels import retrieval_top1
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    t0 = time.perf_counter()
    with k1_recording() as levels, k2_recording() as k2_shapes:
        out = online_window.session("cuda", ONLINE_ANCHORS["frames"],
                                    ONLINE_ANCHORS["loops"], ONLINE_SOLVES)
    launches = fused_reduction_level.launches
    check(fused_reduction_level_ref.calls == 0,
          "the plain level ran on the online window")
    out["k2_launches"] = sum(k2_shapes.values())
    out["k3_launches"] = retrieval_top1.launches
    check(out["k2_launches"] == out["k3_launches"] == 0,
          "K2 or K3 launched on the online window")
    faults = []
    for k, (got, want) in enumerate(zip(out["solves"],
                                        ONLINE_ANCHORS["solves"])):
        print(f"online solve {k}: iterations {got['iterations']} (anchor "
              f"{want['iterations']}) cost {got['cost']!r} (anchor "
              f"{want['cost']!r}) total {got['total_ms']:.1f} ms", flush=True)
        faults += [(k, f) for f in online_window.held_to(got, want)]
    check(not faults, f"online window off its anchors: {faults}")
    check(launches > 0, "K1 never launched on the online window")
    out["k1_launches"] = launches
    out["k1_levels"] = [[m, t, n] for (m, t), n in sorted(levels.items())]
    out["k1_checked"] = estimator_checks_k1(levels)
    out["anchored"] = min(len(out["solves"]), len(ONLINE_ANCHORS["solves"]))
    out["seconds"] = time.perf_counter() - t0
    print("online window", json.dumps(out), flush=True)
    return out


def measurement_phase() -> dict:
    """Phase 14a: (a) bf16 parity, (b) the CPU baseline and the bench, (c)
    the online window."""
    t0 = time.perf_counter()
    out = dict(bf16=bf16_parity())
    out["bench"] = bench_phase()
    out["online"] = online_phase()
    out["seconds"] = time.perf_counter() - t0
    print(f"measurement phase {out['seconds']:.1f} s (CPU baseline "
          f"{out['bench']['baseline_s']:.1f} s, bench "
          f"{out['bench']['seconds'] - out['bench']['baseline_s']:.1f} s, "
          f"online window {out['online']['seconds']:.1f} s)", flush=True)
    return out


def sweep_phase() -> dict:
    """Phase 15a (a): python -m omniswarm_torch.tools.window_scale_sweep's
    rows at every F of SWEEP_FRAMES, one timed solve a size (the tool takes
    the median of 3): K1 at SOLVE_LEVELS's shapes for (F, 5) once an
    iteration, no plain level; each F within 1% of its JAX-CPU cost, with
    its loops, iteration count and linear path; SWEEP_REPEATED solved twice
    (bit-equal); relative ATE below raw VIO's at every F."""
    import torch

    from omniswarm_torch.solver.fused_level import fused_reduction_level_ref
    from omniswarm_torch.tools.window_scale_sweep import sweep_row

    t0 = time.perf_counter()
    out = {}
    for F in SWEEP_FRAMES:
        big = F == SWEEP_REPEATED
        with k1_recording():
            row = sweep_row(F, torch.device("cuda"), iters=SWEEP_ITERS,
                            reps=0, repeat=big)
        it = row["iterations"]
        # the kernel launches of the first solve, as the tool recorded them
        check_k1_levels(F, collections.Counter(
            {(m, t): n for m, t, n in row["k1_levels"]}), it)
        check(fused_reduction_level_ref.calls == 0,
              f"sweep F={F}: the plain level ran")
        print("window scale", json.dumps(row), flush=True)
        check(math.isfinite(row["final_cost"])
              and row["final_cost"] < row["initial_cost"],
              f"sweep F={F}: cost {row['final_cost']} not below "
              f"{row['initial_cost']}")
        check(row["relative_ate"] < row["vio_relative_ate"],
              f"sweep F={F}: relative ATE {row['relative_ate']} not below "
              f"raw VIO's {row['vio_relative_ate']}")
        want = SWEEP_ANCHORS[F]
        held(f"sweep F={F} cost", row["final_cost"], want["cost"])
        check((it, row["loops"], row["linear"]) == (
            want["iterations"], want["loops"], want["linear"]),
            f"sweep F={F}: {it} iterations, {row['loops']} loops, "
            f"{row['linear']}; anchor {want}")
        if big:
            check(row["repeat_equal"], f"sweep F={F}: two solves differ")
        out[F] = row
    return dict(rows=out, seconds=time.perf_counter() - t0)


def dense_tool() -> dict:
    """Phase 13a (b): the loop-dense window through
    python -m omniswarm_torch.tools.bench_dense_loops (exact=True, each run's
    unperturbed solve timed and repeated), each PCG run and the exact one
    held to SOLVER_ANCHORS["dense_loops_1024"] (cost 1%, iterations,
    bit-equal repeat, relative ATE below raw VIO's, K1 at the F=1024 shapes
    on the packed runs, none on the exact one); the Woodbury run
    (linear="smw", no anchor) to a repeat, a cost decrease and K1's
    shapes."""
    import torch

    from omniswarm_torch.solver.fused_level import fused_reduction_level_ref
    from omniswarm_torch.tools import bench_dense_loops

    with k1_recording():
        res = bench_dense_loops.measure(
            torch.device("cuda"), iters=DENSE_ITERS, reps=0, exact=True,
            repeat=True)
    check(fused_reduction_level_ref.calls == 0,
          "the plain level ran on the dense window")
    anchors = SOLVER_ANCHORS["dense_loops_1024"]
    out = {}
    for key in bench_dense_loops.runs(exact=True):
        row, name = res[key], key.replace("pcg_cg", "pcg")
        it = row["iterations"]
        print(f"dense {name}", json.dumps(row), flush=True)
        check(row["repeat_equal"], f"dense {name}: two solves differ")
        check(row["final_cost"] < row["initial_cost"]
              and row["relative_ate"] < row["vio_relative_ate"],
              f"dense {name}: cost or relative ATE not below the start")
        if key == "exact":
            check(row["k1_launches"] == 0, "dense exact launched K1")
        else:
            check_k1_levels(1024, collections.Counter(
                {(m, t): n for m, t, n in row["k1_levels"]}), it)
        if name in anchors:
            held(f"dense {name} cost", row["final_cost"],
                 anchors[name]["cost"])
            check(it == anchors[name]["iterations"],
                  f"dense {name}: {it} iterations")
        out[name] = dict(path=f"dense {name}", F=1024, loops=res["loops"],
                         cost=row["final_cost"],
                         anchor_cost=anchors.get(name, {}).get("cost"),
                         iterations=it, relative_ate=row["relative_ate"],
                         vio_relative_ate=row["vio_relative_ate"],
                         launches=row["k1_launches"],
                         levels=row["k1_levels"],
                         ms_per_iteration=row["ms_per_iter"])
    return out


def replay_phase() -> dict:
    """Phase 15a (b): python -m omniswarm_torch.tools.replay_eval on CSV
    logs written from the simulator, held to REPLAY_ANCHOR: the same solves
    over the same windows, every one solved, each solve's cost within
    REPLAY_COST_RTOL and each summary.json value within REPLAY_ATOL,
    relative ATE below raw VIO's, the anchor's iteration counts. The
    estimator caps a solve at max_solver_time (0.5 s) over the ms an
    iteration it measured, in steps of 25 with 25 the least, so the counts
    would follow the host's speed: the tool runs with max_solver_time 1e-6
    s, as its anchor did, and every solve after the second gets the least
    budget on any host."""
    import functools
    from unittest import mock

    from omniswarm_torch.tools import replay_eval

    t0 = time.perf_counter()
    paths = replay_eval.write_sim_logs(f"{WORK_DIR}/replay_logs",
                                       **REPLAY_LOGS)
    with mock.patch.object(replay_eval, "SolverParams", functools.partial(
            replay_eval.SolverParams, max_solver_time=1e-6)):
        res = replay_eval.main(
            ["--logs", *(f"{p}:{o}" for p, o in zip(paths, REPLAY_OFFSETS)),
             "--loops", "--out", f"{WORK_DIR}/replay_out"])
    want = REPLAY_ANCHOR["solves"]
    got = [{k: s[k] for k in ("solved", "num_frames", "cost", "iterations")}
           for s in res["solves"]]
    print(f"replay solves {json.dumps(got)} anchor {json.dumps(want)}",
          flush=True)
    check([(s["solved"], s["num_frames"], s["iterations"]) for s in got]
          == [(s["solved"], s["num_frames"], s["iterations"]) for s in want],
          "replay: solves, windows or iterations differ from the anchor's")
    for i, (s, a) in enumerate(zip(got, want)):
        check(abs(s["cost"] - a["cost"]) <= REPLAY_COST_RTOL * a["cost"],
              f"replay solve {i}: cost {s['cost']} not within "
              f"{REPLAY_COST_RTOL:.0%} of {a['cost']}")

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    with open(f"{WORK_DIR}/replay_out/summary.json") as f:
        summary = dict(flat(json.load(f)))
    anchor = dict(flat(REPLAY_ANCHOR["summary"]))
    check(summary.keys() == anchor.keys(), "replay: summary keys differ")
    worst = max(abs(summary[k] - anchor[k]) for k in anchor)
    check(worst <= REPLAY_ATOL, f"replay: summary {worst} from its anchor")
    check(res["relative_ate"] < res["vio_relative_ate"],
          f"replay: relative ATE {res['relative_ate']} not below raw VIO's")
    return dict(solves=got, summary_max_abs_err=worst,
                relative_ate=res["relative_ate"],
                vio_relative_ate=res["vio_relative_ate"],
                seconds=time.perf_counter() - t0)


def textured_phase() -> dict:
    """Phase 15a (c): python -m omniswarm_torch.tools.eval_superpoint_textured
    on the bundled SuperPoint checkpoints: K2 launched at
    K2_TRAIN_SHAPES's (1, 64, 96) only, no plain version, K1 and K3 never;
    photo_v2's textured and flat rows within TRAIN_FLIPS of phase 12a's
    anchors (matches and correct matches)."""
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1)
    from omniswarm_torch.solver.fused_level import fused_reduction_level
    from omniswarm_torch.tools import eval_superpoint_textured

    t0 = time.perf_counter()
    args = [a for c in TEXTURED_CKPTS for a in ("--ckpt", c)]
    with k1_recording(), k2_recording() as shapes:
        res = eval_superpoint_textured.main(
            [*args, "--n-eval", str(TEXTURED_N_EVAL), "--out",
             f"{WORK_DIR}/sp_eval.json"])
    launches = dict(k1=fused_reduction_level.launches,
                    k2=grid_nms.launches, k3=retrieval_top1.launches)
    check(grid_nms_ref.calls == 0 and launches["k2"] > 0
          and launches["k1"] == launches["k3"] == 0
          and set(shapes) <= {K2_TRAIN_SHAPES[0]},
          f"textured eval: launches {launches} at {dict(shapes)}")
    photo = res["checkpoints"]["photo_v2"]
    for row in ("textured", "flat"):
        m = dict(matches=photo[f"{row}_matches"], correct=round(
            photo[f"{row}_match_precision"] * photo[f"{row}_matches"]))
        train_flips(f"textured eval photo_v2 {row}", m,
                    TRAIN_ANCHORS["superpoint"]["matching"][row],
                    ("matches", "correct"))
    return dict(checkpoints=res["checkpoints"], launches=launches,
                k2_shapes=[[*k, n] for k, n in sorted(shapes.items())],
                seconds=time.perf_counter() - t0)


def bus_processes():
    """Phase 15a (d), started: two python -m
    omniswarm_torch.tools.network_tester processes (drones 0 and 1, 2
    keyframes a second for BUS_SECONDS) and python -m
    omniswarm_torch.tools.bus_spy on BUS_PORT over loopback multicast."""
    common = ["--port", str(BUS_PORT)]
    testers = [subprocess.Popen(
        [sys.executable, "-m", "omniswarm_torch.tools.network_tester",
         "--drone-id", str(d), "--rate", "2", "--duration",
         str(BUS_SECONDS), *common], stdout=subprocess.PIPE, text=True)
        for d in (0, 1)]
    spy = subprocess.Popen(
        [sys.executable, "-m", "omniswarm_torch.tools.bus_spy", "--interval",
         "1", "--duration", str(BUS_SECONDS + 8), *common],
        stdout=subprocess.PIPE, text=True)
    return testers, spy


def bus_results(testers, spy) -> dict:
    """Phase 15a (d), ended: both testers exit 0, each received the other's
    keyframes (the receive rate printed), the spy heard both drones on the
    keyframe channels."""
    import re

    out = {}
    for d, p in enumerate(testers):
        text = p.communicate(timeout=120)[0]
        print(f"network tester {d}: {text.strip()}", flush=True)
        m = re.search(r"sent (\d+) keyframes; received (\d+) from peers",
                      text)
        rate = re.search(rf"drone {1 - d}: receive rate ([\d.]+)%", text)
        check(p.returncode == 0 and m is not None and rate is not None
              and int(m.group(2)) > 0,
              f"network tester {d}: exit {p.returncode}")
        out[d] = dict(sent=int(m.group(1)), received=int(m.group(2)),
                      receive_rate_pct=float(rate.group(1)))
    text = spy.communicate(timeout=120)[0]
    check(spy.returncode == 0 and "VIOKF_HEADER" in text
          and "drone 0:" in text and "drone 1:" in text,
          f"bus spy: exit {spy.returncode}, heard {text[-300:]!r}")
    print(f"bus spy: {len(text.splitlines())} lines, both drones heard",
          flush=True)
    return out


def tools_phase() -> dict:
    """Phase 15a: the repository's remaining tools (see the docstring)."""
    t0 = time.perf_counter()
    out = dict(sweep=sweep_phase())
    out["replay"] = replay_phase()
    testers, spy = bus_processes()
    out["textured"] = textured_phase()
    out["bus"] = bus_results(testers, spy)
    out["seconds"] = time.perf_counter() - t0
    print("tools", json.dumps(out), flush=True)
    print(f"tools phase {out['seconds']:.1f} s (sweep "
          f"{out['sweep']['seconds']:.1f} s, replay "
          f"{out['replay']['seconds']:.1f} s, textured eval "
          f"{out['textured']['seconds']:.1f} s)", flush=True)
    return out


def convert_phase() -> dict:
    """Phase 16a (a): the weight converter, the converted SuperPoint on the
    card against its twin, and K2 launched from the converted file."""
    import torch

    from omniswarm_torch import kernels
    from omniswarm_torch.core.precision import highp
    from omniswarm_torch.models.superpoint import (
        SuperPoint, SuperPointExtractor, load_params_npz, net_state)
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1)
    from omniswarm_torch.solver.fused_level import fused_reduction_level
    from omniswarm_torch.tools import convert_superpoint as conv

    t0 = time.perf_counter()
    work = f"{WORK_DIR}/convert"
    os.makedirs(work, exist_ok=True)
    twin = conv.seeded_twin(0)
    torch.save(twin.state_dict(), f"{work}/sp.pth")
    rng = np.random.default_rng(0)
    np.savetxt(f"{work}/c.csv", rng.normal(size=(64, 256)), delimiter=",")
    np.savetxt(f"{work}/m.csv", rng.normal(size=(1, 256)), delimiter=",")
    plain = conv.main(["--pth", f"{work}/sp.pth", "--out", f"{work}/sp.npz"])
    pca = conv.main(["--pth", f"{work}/sp.pth", "--pca-components",
                     f"{work}/c.csv", "--pca-mean", f"{work}/m.csv",
                     "--out", f"{work}/sp_pca.npz"])
    want_keys = sorted(f"{n}.{leaf}" for n in conv.LAYERS
                       for leaf in ("weight", "bias"))
    check(sorted(plain) == want_keys and sorted(pca) == sorted(
        want_keys + ["pca_components", "pca_mean"])
          and all(v.dtype == np.float32 for v in pca.values()),
          f"converter keys {sorted(pca)}")

    B, H, W = CONVERT_SHAPE
    imgs = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(B, 1, H, W)).astype(np.float32)).cuda()
    sp = SuperPoint().cuda().eval()
    sp.load_state_dict(net_state(load_params_npz(f"{work}/sp.npz")))
    twin = twin.cuda()
    errs = {}
    with highp(), torch.no_grad():
        got, want = sp(imgs), twin(imgs)
        for name, g, w in zip(("heat", "desc"), got, want):
            close = torch.allclose(g, w, **CONVERT_BARS)
            errs[name] = float((g - w).abs().max())
            check(close, f"converted SuperPoint {name}: max abs err "
                  f"{errs[name]}")
        ex = SuperPointExtractor(load_params_npz(f"{work}/sp_pca.npz")
                                 ).cuda().eval()
        with k1_recording(), k2_recording() as shapes:
            xy, scores, desc, valid = ex(imgs)
            torch.cuda.synchronize()
        launches = dict(k1=fused_reduction_level.launches,
                        k2=grid_nms.launches, k3=retrieval_top1.launches)
        check(grid_nms_ref.calls == 0 and launches["k2"] == 1
              and launches["k1"] == launches["k3"] == 0
              and set(shapes) == {CONVERT_SHAPE},
              f"converted extractor: launches {launches} at {dict(shapes)}")
        check(bool(valid.any()) and bool(torch.isfinite(desc).all())
              and desc.shape[-1] == 64, "converted extractor: no keypoints")
        heat = want[0].contiguous()
        k2 = kernels.grid_nms(heat, ex.nms_dist)
        ref = grid_nms_ref(heat, ex.nms_dist)
        torch.cuda.synchronize()
        check(torch.equal(k2, ref), "K2 disagrees on the twin's heat")
    checked = [dict(shape=list(CONVERT_SHAPE), r=ex.nms_dist,
                    kind="converted_twin_heat", aligned=True,
                    kept=int((k2 > 0).sum()),
                    max_abs_err=float((k2 - ref).abs().max()))]
    return dict(keys=len(pca), max_abs_err=errs, launches=launches,
                keypoints=int(valid.sum()), k2_checked=checked,
                seconds=time.perf_counter() - t0)


def drift_phase() -> dict:
    """Phase 16a (b): tools.drift_probe against this tree, one pair."""
    from omniswarm_torch.tools import drift_probe

    t0 = time.perf_counter()
    res = drift_probe.probe(".", device="cuda", order=DRIFT_ORDER,
                            reps=DRIFT_REPS)
    rows, summary = res["rows"], res["summary"]
    check(summary["iters_equal"] and summary["costs_equal"],
          f"drift_probe: iterations {[r['iters'] for r in rows]}, costs "
          f"{[r['cost'] for r in rows]}")
    check(all(r["k1_launches"] > 0 for r in rows),
          f"drift_probe: K1 launches {[r['k1_launches'] for r in rows]}")
    return dict(summary=summary, rows=rows,
                k1_launches=sum(r["k1_launches"] for r in rows),
                seconds=time.perf_counter() - t0)


def comm_phase() -> dict:
    """Phase 16a (c): tools.comm_model at F = 256 against COMM_MODEL.json,
    the fleet, and one world-1 timing on the card."""
    from omniswarm_torch.benchutil import card
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)
    from omniswarm_torch.tools import comm_model

    t0 = time.perf_counter()
    comm = comm_model.traffic(COMM_FRAMES, ndev=8, timeout_s=300)
    with open("COMM_MODEL.json") as f:
        recorded = {r["F"]: r for r in json.load(f)["frame_sharded"]}
    for row in comm["frame_sharded"]:
        want = recorded[row["F"]]
        lm = row["lm_iteration"]
        check(lm["by_op"] == comm_model.expected_by_op(want["by_op"])
              and row["loops"] == want["loops"],
              f"comm_model F={row['F']}: {lm['by_op']} against "
              f"{want['by_op']} + {comm_model.NAMED_DIFFERENCE}")
    check(comm["fleet_layout_zero_data_collectives"],
          f"comm_model fleet: {comm['fleet_layout_counters']}")
    with k1_recording() as levels:
        t1 = comm_model.world1_ms(COMM_FRAMES, "cuda")
    launches = fused_reduction_level.launches
    check(launches > 0 and fused_reduction_level_ref.calls == 0,
          f"comm_model world-1 timing: K1 {launches}, plain "
          f"{fused_reduction_level_ref.calls}")
    out = comm_model.predict(comm, t1, card("cuda:0"))
    return dict(model=out, k1_launches=launches,
                k1_levels=[[m, t, n] for (m, t), n in sorted(levels.items())],
                k1_checked=estimator_checks_k1(levels),
                seconds=time.perf_counter() - t0)


def reference_tools_phase() -> dict:
    """Phase 16a: the last reference tools (see the docstring)."""
    t0 = time.perf_counter()
    out = dict(convert=convert_phase(), drift=drift_phase(),
               comm=comm_phase())
    out["seconds"] = time.perf_counter() - t0
    print("reference tools", json.dumps(out), flush=True)
    print(f"reference tools phase {out['seconds']:.1f} s (convert "
          f"{out['convert']['seconds']:.1f} s, drift_probe "
          f"{out['drift']['seconds']:.1f} s, comm_model "
          f"{out['comm']['seconds']:.1f} s)", flush=True)
    return out


def main() -> int:
    start = time.perf_counter()
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

    from omniswarm_torch.benchutil import card as card_of

    card = card_of("cuda:0")
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    build_s = kernels.build()
    print(f"kernel build {build_s:.2f} s", flush=True)
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    seconds = {"kernel build": round(build_s, 1)}

    def phase(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"{name} phase {seconds[name]:.1f} s", flush=True)
        return out

    from omniswarm_torch.entry import entry
    from omniswarm_torch.frontend_entry import prepare

    # library handles and allocator, outside the counted runs
    phase("warm-up", lambda: entry(device="cuda", max_iterations=2))
    card_tests = phase("kernel checks", kernel_checks)
    paths = {F: phase(f"main path F={F}", main_path_phase, F, per_iter,
                      ref_cost, ate_bar)
             for F, per_iter, ref_cost, ate_bar in MAIN_PATHS}
    solver = phase("solver paths", solver_phases, paths)
    prep = phase("front-end render", prepare)  # phase 7's and 9a's views
    frontend = phase("front-end path", frontend_phase, prep)
    rgbd = phase("RGB-D path", rgbd_phase)
    estimator = phase("estimator path", estimator_phase)
    demos = phase("demos", demos_phase, prep)
    phase("layouts", layouts_phase)
    phase("node", node_phase, demos["feature_reports"])
    phase("training", training_phase, card)
    phase("tier-10", tier10_phase)
    phase("measurement", measurement_phase)
    phase("tools", tools_phase)
    phase("reference tools", reference_tools_phase)

    print("kernels", json.dumps(dict(card_tests, launches={
        **{f"main path F={F} K1": paths[F]["launches"] for F in paths},
        "estimator K1": estimator["k1_launches"],
        "front-end K2/K3/E1/C1": [frontend[f"{k}_launches"] for k in
                                  ("k2", "k3", "epilogue", "c1")],
        "RGB-D C1/E1/K2/K3": list(rgbd["launches"].values())})),
        flush=True)
    print("solver paths", json.dumps(solver), flush=True)
    print("phase seconds", json.dumps(seconds), flush=True)
    print(f"chip_smoke {time.perf_counter() - start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
