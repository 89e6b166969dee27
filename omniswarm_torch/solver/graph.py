"""Fixed-shape, masked factor-graph containers and the host-side builder.

Counterpart of ``omniswarm_tpu/solver/graph.py``. The state is a dense
``(F, D, 4)`` pose grid (F window frames x D drones) and every factor family
is a fixed-capacity struct-of-arrays with a validity mask. A pose is
addressed by ``(frame, drone)``; its flat node id is ``frame * D + drone``
and its parameters occupy ``[4*node, 4*node+4)`` of the flat state.

``GraphBuilder.build`` returns numpy leaves, as ``dense_graph_from_sim``
does; the solvers (``gauss_newton.lm_solve``) move them to the device in one
pass through ``convert.factor_graph_to_torch``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RangeFactors(NamedTuple):
    """UWB distance factors between two drones in the same frame."""

    frame: torch.Tensor     # (R,) int
    drone_a: torch.Tensor   # (R,) int
    drone_b: torch.Tensor   # (R,) int
    dist: torch.Tensor      # (R,) f32
    sqrt_inf: torch.Tensor  # (R,) f32
    valid: torch.Tensor     # (R,) bool


class RelPoseFactors(NamedTuple):
    """4-DoF relative pose factors: ego-motion chains and loop edges."""

    frame_a: torch.Tensor    # (L,) int
    drone_a: torch.Tensor    # (L,) int
    frame_b: torch.Tensor    # (L,) int
    drone_b: torch.Tensor    # (L,) int
    dpose: torch.Tensor      # (L, 4)
    sqrt_info: torch.Tensor  # (L, 4, 4)
    valid: torch.Tensor      # (L,) bool


class DetectionFactors(NamedTuple):
    """Visual drone-to-drone bearing (+ inverse depth) factors; ``dpose_a``
    and ``dpose_b`` fold in camera extrinsic / self-motion corrections."""

    frame_a: torch.Tensor       # (K,) int
    drone_a: torch.Tensor       # (K,) int
    frame_b: torch.Tensor       # (K,) int
    drone_b: torch.Tensor       # (K,) int
    direction: torch.Tensor     # (K, 3) unit bearing
    tangent_base: torch.Tensor  # (K, 2, 3)
    inv_dep: torch.Tensor       # (K,)
    dpose_a: torch.Tensor       # (K, 4)
    dpose_b: torch.Tensor       # (K, 4)
    enable_depth: torch.Tensor  # (K,) bool
    valid: torch.Tensor         # (K,) bool


class FactorGraph(NamedTuple):
    """The full masked problem over a (F, D, 4) pose grid."""

    ranges: RangeFactors
    odoms: RelPoseFactors       # ego-motion chains (no robust loss)
    loops: RelPoseFactors       # loop closures (robust)
    dets: DetectionFactors      # bearing detections (robust)
    pose_valid: torch.Tensor    # (F, D) bool: pose exists in the window
    pose_fixed: torch.Tensor    # (F, D) bool: gauge-fixed
    yaw_fixed: torch.Tensor     # (F, D) bool: yaw frozen
    # Optional per-drone UWB antenna offsets (D, 3), body frame; None == 0
    ant_pos: torch.Tensor = None

    @property
    def num_frames(self) -> int:
        return self.pose_valid.shape[0]

    @property
    def num_drones(self) -> int:
        return self.pose_valid.shape[1]


def empty_ranges(capacity: int, dtype=torch.float32,
                 device="cpu") -> RangeFactors:
    zi = torch.zeros((capacity,), dtype=torch.int64, device=device)
    zf = torch.zeros((capacity,), dtype=dtype, device=device)
    return RangeFactors(zi, zi, zi, zf, zf,
                        torch.zeros((capacity,), dtype=torch.bool,
                                    device=device))


def empty_relpose(capacity: int, dtype=torch.float32,
                  device="cpu") -> RelPoseFactors:
    zi = torch.zeros((capacity,), dtype=torch.int64, device=device)
    return RelPoseFactors(
        zi, zi, zi, zi,
        torch.zeros((capacity, 4), dtype=dtype, device=device),
        torch.zeros((capacity, 4, 4), dtype=dtype, device=device),
        torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def empty_detections(capacity: int, dtype=torch.float32,
                     device="cpu") -> DetectionFactors:
    zi = torch.zeros((capacity,), dtype=torch.int64, device=device)

    def zf(*shape):
        return torch.zeros((capacity,) + shape, dtype=dtype, device=device)

    zb = torch.zeros((capacity,), dtype=torch.bool, device=device)
    return DetectionFactors(zi, zi, zi, zi, zf(3), zf(2, 3), zf(), zf(4),
                            zf(4), zb, zb)


def empty_graph(max_frames: int, max_drones: int, max_ranges: int = 4096,
                max_odoms: int = 1024, max_loops: int = 1024,
                max_dets: int = 1024, device="cpu") -> FactorGraph:
    zb = torch.zeros((max_frames, max_drones), dtype=torch.bool,
                     device=device)
    return FactorGraph(
        ranges=empty_ranges(max_ranges, device=device),
        odoms=empty_relpose(max_odoms, device=device),
        loops=empty_relpose(max_loops, device=device),
        dets=empty_detections(max_dets, device=device),
        pose_valid=zb, pose_fixed=zb, yaw_fixed=zb,
    )


class GraphBuilder:
    """Host-side (numpy) accumulator producing a FactorGraph.

    The ``add_*`` methods are cheap list appends; ``build`` lays every
    family out at its capacity with a validity mask (numpy leaves).
    """

    def __init__(self, max_frames: int, max_drones: int,
                 max_ranges: int = 4096, max_odoms: int = 1024,
                 max_loops: int = 1024, max_dets: int = 1024):
        self.F, self.D = max_frames, max_drones
        self.caps = dict(ranges=max_ranges, odoms=max_odoms,
                         loops=max_loops, dets=max_dets)
        self.ranges = []
        self.odoms = []
        self.loops = []
        self.dets = []
        self.pose_valid = np.zeros((max_frames, max_drones), bool)
        self.pose_fixed = np.zeros((max_frames, max_drones), bool)
        self.yaw_fixed = np.zeros((max_frames, max_drones), bool)
        self.ant_pos = None

    def set_antenna(self, drone: int, offset) -> None:
        """Per-drone UWB antenna offset in the body frame."""
        if self.ant_pos is None:
            self.ant_pos = np.zeros((self.D, 3), np.float32)
        self.ant_pos[drone] = np.asarray(offset, np.float32)

    def set_pose_valid(self, frame: int, drone: int, fixed: bool = False):
        self.pose_valid[frame, drone] = True
        if fixed:
            self.pose_fixed[frame, drone] = True

    def add_range(self, frame: int, drone_a: int, drone_b: int,
                  dist: float, cov: float):
        self.ranges.append((frame, drone_a, drone_b, dist, 1.0 / np.sqrt(cov)))

    def add_odom(self, drone: int, frame_a: int, frame_b: int,
                 dpose, sqrt_info):
        self.odoms.append((frame_a, drone, frame_b, drone,
                           np.asarray(dpose, np.float32),
                           np.asarray(sqrt_info, np.float32)))

    def add_loop(self, frame_a: int, drone_a: int, frame_b: int, drone_b: int,
                 dpose, sqrt_info):
        self.loops.append((frame_a, drone_a, frame_b, drone_b,
                           np.asarray(dpose, np.float32),
                           np.asarray(sqrt_info, np.float32)))

    def add_detection(self, frame_a: int, drone_a: int, frame_b: int,
                      drone_b: int, direction, tangent_base, inv_dep: float,
                      dpose_a=None, dpose_b=None, enable_depth: bool = True):
        ident = np.zeros(4, np.float32)
        self.dets.append((
            frame_a, drone_a, frame_b, drone_b,
            np.asarray(direction, np.float32),
            np.asarray(tangent_base, np.float32),
            float(inv_dep),
            ident if dpose_a is None else np.asarray(dpose_a, np.float32),
            ident if dpose_b is None else np.asarray(dpose_b, np.float32),
            bool(enable_depth),
        ))

    def _relpose_arrays(self, rows, cap) -> RelPoseFactors:
        n = len(rows)
        assert n <= cap, f"relpose capacity exceeded: {n} > {cap}"
        fa = np.zeros(cap, np.int32)
        da = np.zeros(cap, np.int32)
        fb = np.zeros(cap, np.int32)
        db = np.zeros(cap, np.int32)
        dp = np.zeros((cap, 4), np.float32)
        si = np.zeros((cap, 4, 4), np.float32)
        valid = np.zeros(cap, bool)
        for i, (a, d1, b, d2, p, s) in enumerate(rows):
            fa[i], da[i], fb[i], db[i] = a, d1, b, d2
            dp[i], si[i] = p, s
            valid[i] = True
        return RelPoseFactors(fa, da, fb, db, dp, si, valid)

    def build(self) -> FactorGraph:
        cap = self.caps["ranges"]
        n = len(self.ranges)
        assert n <= cap, f"range capacity exceeded: {n} > {cap}"
        rf = np.zeros(cap, np.int32)
        ra = np.zeros(cap, np.int32)
        rb = np.zeros(cap, np.int32)
        rd = np.zeros(cap, np.float32)
        ri = np.zeros(cap, np.float32)
        rv = np.zeros(cap, bool)
        for i, (f, a, b, d, s) in enumerate(self.ranges):
            rf[i], ra[i], rb[i], rd[i], ri[i], rv[i] = f, a, b, d, s, True
        ranges = RangeFactors(rf, ra, rb, rd, ri, rv)

        cap = self.caps["dets"]
        n = len(self.dets)
        assert n <= cap, f"detection capacity exceeded: {n} > {cap}"
        fa = np.zeros(cap, np.int32)
        da = np.zeros(cap, np.int32)
        fb = np.zeros(cap, np.int32)
        db = np.zeros(cap, np.int32)
        dirs = np.zeros((cap, 3), np.float32)
        tb = np.zeros((cap, 2, 3), np.float32)
        invd = np.zeros(cap, np.float32)
        dpa = np.zeros((cap, 4), np.float32)
        dpb = np.zeros((cap, 4), np.float32)
        ed = np.zeros(cap, bool)
        dv = np.zeros(cap, bool)
        for i, row in enumerate(self.dets):
            fa[i], da[i], fb[i], db[i] = row[0], row[1], row[2], row[3]
            dirs[i], tb[i], invd[i], dpa[i], dpb[i], ed[i] = row[4:10]
            dv[i] = True
        dets = DetectionFactors(fa, da, fb, db, dirs, tb, invd, dpa, dpb, ed,
                                dv)

        return FactorGraph(
            ranges=ranges,
            odoms=self._relpose_arrays(self.odoms, self.caps["odoms"]),
            loops=self._relpose_arrays(self.loops, self.caps["loops"]),
            dets=dets,
            pose_valid=self.pose_valid.copy(),
            pose_fixed=self.pose_fixed.copy(),
            yaw_fixed=self.yaw_fixed.copy(),
            ant_pos=None if self.ant_pos is None else self.ant_pos.copy(),
        )


def diag_sqrt_info(pos_std: float, yaw_std: float,
                   dtype=np.float32) -> np.ndarray:
    """Diagonal 4x4 sqrt information from position / yaw stddevs."""
    return np.diag([1.0 / pos_std] * 3 + [1.0 / yaw_std]).astype(dtype)


def sqrt_info_from_cov4(cov4: np.ndarray) -> np.ndarray:
    """Elementwise |inv(cov)|^0.5 (the reference's whitening convention,
    not a matrix square root)."""
    return np.sqrt(np.abs(np.linalg.inv(cov4)))
