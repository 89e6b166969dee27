"""Vectorized direct-to-DenseGraph window assembly (the online hot path).

A copy of ``omniswarm_tpu/swarm/fastbuild.py``, with the port's DenseGraph,
RelPoseFactors and PCM. The per-solve host graph build is

1. ``WindowGrids`` — numpy pose/validity/range grids maintained
   INCREMENTALLY on keyframe admission/eviction (O(row) per event), and
2. ``build_dense_fast`` — a fully vectorized assembly of the solver's
   DenseGraph leaves: ego-motion chains, UWB gating, loop anchoring + PCM +
   same-pair averaging, and detection factors are batched array programs
   with no per-measurement Python. The leaves stay numpy; the solve moves
   them to the device in one upload.

PCM runs incrementally per drone pair: pairs never classified are computed
synchronously; pairs whose loop set changed serve their previous verdicts
this solve and launch the consistency mask on the device
(``_filter_loops_fast``), which runs during the LM solve and is folded in
by ``consume_pcm_pending`` at ``finalize_solve``.

``build_dense_fast`` reproduces the factor content of
``SwarmEstimator._build`` + ``dense_from_factor_graph`` exactly; the slow
path remains the structural fallback (odom-chain gaps from drones missing
mid-window, cross-frame detection anchors — cases the dense frame layout
cannot represent).

Reference behaviors (re-designed, not translated): keyframe bookkeeping
judge_is_key_frame/process_frame_clear (swarm_localization_solver.cpp:
108-202), problem assembly setup_problem_with_* (solver.cpp:1064-1198), UWB
gating outlier_rejection_frame (:408-515), loop re-anchoring
loop_from_src_loop_connection (:1464-1553), average_same_loop (:1555-1592).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from omniswarm_torch.core.trajectory import drift_variances
from omniswarm_torch.sim.simulator import delta_pose_np, pose_mul_np, wrap
from omniswarm_torch.solver.dense import DenseGraph
from omniswarm_torch.solver.graph import RelPoseFactors


class WindowGrids:
    """Sliding-window state as dense numpy grids, updated incrementally.

    Columns cover every drone ever seen (sorted by id, grown in place);
    ``build_dense_fast`` selects the currently active columns per solve.
    Row operations mirror the estimator's window list exactly: ``admit``
    appends, ``evict(i)`` deletes row i.
    """

    def __init__(self):
        self.ids: List[int] = []
        self.times = np.zeros((0,), np.float64)
        self.poses = np.zeros((0, 0, 4), np.float64)
        self.valid = np.zeros((0, 0), bool)
        self.rng_dist = np.zeros((0, 0, 0), np.float64)
        self.rng_valid = np.zeros((0, 0, 0), bool)

    @property
    def nrows(self) -> int:
        return self.times.shape[0]

    def _col(self, d: int) -> int:
        """Column of drone d, inserting a new sorted column if unseen."""
        import bisect

        i = bisect.bisect_left(self.ids, d)
        if i < len(self.ids) and self.ids[i] == d:
            return i
        self.ids.insert(i, d)
        self.poses = np.insert(self.poses, i, 0.0, axis=1)
        self.valid = np.insert(self.valid, i, False, axis=1)
        self.rng_dist = np.insert(self.rng_dist, i, 0.0, axis=1)
        self.rng_dist = np.insert(self.rng_dist, i, 0.0, axis=2)
        self.rng_valid = np.insert(self.rng_valid, i, False, axis=1)
        self.rng_valid = np.insert(self.rng_valid, i, False, axis=2)
        return i

    def admit(self, t: float, vio: Dict[int, np.ndarray],
              ranges: Dict[Tuple[int, int], float]) -> None:
        # grow columns FIRST (vio drones and range-referenced drones both —
        # a range can name a drone whose first VIO arrives in a later
        # frame; its column must exist so this frame's range is kept)
        for d in vio:
            self._col(d)
        for (a, b) in ranges:
            self._col(a)
            self._col(b)
        D = len(self.ids)
        prow = np.zeros((1, D, 4))
        vrow = np.zeros((1, D), bool)
        drow = np.zeros((1, D, D))
        rrow = np.zeros((1, D, D), bool)
        for d, p in vio.items():
            c = self.ids.index(d)
            prow[0, c] = p
            vrow[0, c] = True
        for (a, b), dist in ranges.items():
            # keep only the a<b half — the assembly's dedup convention
            # (setup_problem_with_sferror adds each pair once)
            if a >= b:
                continue
            ca, cb = self.ids.index(a), self.ids.index(b)
            drow[0, ca, cb] = dist
            rrow[0, ca, cb] = True
        self.times = np.append(self.times, t)
        self.poses = np.concatenate([self.poses, prow], 0)
        self.valid = np.concatenate([self.valid, vrow], 0)
        self.rng_dist = np.concatenate([self.rng_dist, drow], 0)
        self.rng_valid = np.concatenate([self.rng_valid, rrow], 0)

    def evict(self, i: int) -> None:
        self.times = np.delete(self.times, i)
        self.poses = np.delete(self.poses, i, axis=0)
        self.valid = np.delete(self.valid, i, axis=0)
        self.rng_dist = np.delete(self.rng_dist, i, axis=0)
        self.rng_valid = np.delete(self.rng_valid, i, axis=0)

    def rebuild(self, window) -> None:
        """Full resync from the estimator's KeyframeRecord list (anomaly
        recovery path — normal operation stays incremental)."""
        self.__init__()
        for kf in window:
            self.admit(kf.t, kf.vio, kf.ranges)


# ---------------------------------------------------------------------------
# Vectorized lookups
# ---------------------------------------------------------------------------

def _nearest_sorted(ts: np.ndarray, tq: np.ndarray) -> np.ndarray:
    """Index of the element of sorted ``ts`` nearest each ``tq``
    (ties -> earlier element, matching argmin-first semantics)."""
    j = np.searchsorted(ts, tq)
    j0 = np.clip(j - 1, 0, ts.size - 1)
    j1 = np.clip(j, 0, ts.size - 1)
    return np.where(np.abs(ts[j1] - tq) < np.abs(ts[j0] - tq), j1, j0)


def _nearest_kf_vec(grids: WindowGrids, act: np.ndarray, tq: np.ndarray,
                    col_q: np.ndarray, gate: float = 1.5) -> np.ndarray:
    """Vectorized _nearest_kf: frame index of the nearest keyframe
    CONTAINING the drone, or -1 (outside ``gate`` seconds / no frames)."""
    out = np.full(tq.shape[0], -1, np.int64)
    valid = grids.valid[:, act]
    for c in range(act.size):
        sel = np.flatnonzero(col_q == c)
        if sel.size == 0:
            continue
        rows = np.flatnonzero(valid[:, c])
        if rows.size == 0:
            continue
        ts = grids.times[rows]
        pick = _nearest_sorted(ts, tq[sel])
        ok = np.abs(ts[pick] - tq[sel]) <= gate
        out[sel] = np.where(ok, rows[pick], -1)
    return out


def _ego_sorted(est, d: int):
    """(ts_sorted, poses_sorted, cumlen) for one drone's VIO history,
    cached by history length (histories are append-only between prunes)."""
    hist = est.ego.get(d)
    if not hist:
        return None
    cached = est._ego_sorted_cache.get(d)
    if cached is not None and cached[0] == len(hist):
        return cached[1]
    ts = np.asarray([h[0] for h in hist])
    ps = np.asarray([h[1] for h in hist])
    order = np.argsort(ts, kind="stable")
    ts_s, ps_s = ts[order], ps[order]
    seg = np.linalg.norm(np.diff(ps_s[:, :3], axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    est._ego_sorted_cache[d] = (len(hist), (ts_s, ps_s, cum))
    return ts_s, ps_s, cum


def _ego6_sorted(est, d: int):
    hist = est.ego6.get(d)
    if not hist:
        return None
    cached = est._ego6_sorted_cache.get(d)
    if cached is not None and cached[0] == len(hist):
        return cached[1]
    ts = np.asarray([h[0] for h in hist])
    ps = np.asarray([h[1] for h in hist])
    order = np.argsort(ts, kind="stable")
    est._ego6_sorted_cache[d] = (len(hist), (ts[order], ps[order]))
    return est._ego6_sorted_cache[d][1]


def _ego_at_vec(est, drone_q: np.ndarray, tq: np.ndarray):
    """Vectorized _ego_pose_at: (N, 4) poses + found mask."""
    out = np.zeros((tq.shape[0], 4))
    found = np.zeros(tq.shape[0], bool)
    for d in np.unique(drone_q):
        e = _ego_sorted(est, int(d))
        if e is None:
            continue
        ts_s, ps_s, _ = e
        sel = np.flatnonzero(drone_q == d)
        pick = _nearest_sorted(ts_s, tq[sel])
        out[sel] = ps_s[pick]
        found[sel] = True
    return out, found


def _ego6_at_vec(est, drone_q: np.ndarray, tq: np.ndarray, gate: float = 0.5):
    out = np.zeros((tq.shape[0], 7))
    found = np.zeros(tq.shape[0], bool)
    for d in np.unique(drone_q):
        e = _ego6_sorted(est, int(d))
        if e is None:
            continue
        ts_s, ps_s = e
        sel = np.flatnonzero(drone_q == d)
        pick = _nearest_sorted(ts_s, tq[sel])
        ok = np.abs(ts_s[pick] - tq[sel]) <= gate
        out[sel] = ps_s[pick]
        found[sel] = ok
    return out, found


def _path_length_vec(est, drone_q: np.ndarray, t0: np.ndarray,
                     t1: np.ndarray):
    """Vectorized _ego_path_length; (N,) lengths + found mask."""
    out = np.zeros(t0.shape[0])
    found = np.zeros(t0.shape[0], bool)
    for d in np.unique(drone_q):
        e = _ego_sorted(est, int(d))
        if e is None:
            continue
        ts_s, _, cum = e
        sel = np.flatnonzero(drone_q == d)
        i0 = _nearest_sorted(ts_s, t0[sel])
        i1 = _nearest_sorted(ts_s, t1[sel])
        out[sel] = np.abs(cum[i1] - cum[i0])
        found[sel] = True
    return out, found


def _invert_pose_rows(p: np.ndarray) -> np.ndarray:
    return delta_pose_np(p, np.zeros_like(p))


# ---------------------------------------------------------------------------
# Loop filtering (vectorized _filter_loops)
# ---------------------------------------------------------------------------

def _loop_keys_vec(soa) -> np.ndarray:
    """(N, 4) canonical loop identity rows (estimator.loop_key semantics:
    ordered raw drone pair + centisecond-quantized endpoint times)."""
    a = np.stack([soa["da"], np.rint(soa["t_a"] * 100).astype(np.int64)], 1)
    b = np.stack([soa["db"], np.rint(soa["t_b"] * 100).astype(np.int64)], 1)
    swap = (a[:, 0] > b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1]))
    lo = np.where(swap[:, None], b, a)
    hi = np.where(swap[:, None], a, b)
    return np.concatenate([lo, hi], 1)


def consume_pcm_pending(est) -> None:
    """Fold the previous async PCM launch into the verdict cache.

    Called from finalize_solve (the kernel overlapped the device solve)
    and defensively at the top of the next filter pass. Verdicts land
    keyed by loop identity, so window slides between launch and consume
    are harmless."""
    pending = getattr(est, "_pcm_pending", None)
    if pending is None:
        return
    est._pcm_pending = None
    from omniswarm_torch.robust.pcm import pcm_finish_all

    res = pcm_finish_all(pending["handle"])
    cache = est._pcm_pair_cache
    for pair, h in pending["pair_sig"].items():
        cache[pair] = {"h": h, "good": set()}
    keys = pending["keys"]
    pairs = pending["pairs"]
    for j in np.flatnonzero(res.good_mask):
        cache[pairs[j]]["good"].add(tuple(keys[j]))
    est.pair_inliers = {pair: set(ent["good"])
                        for pair, ent in cache.items()}


def _filter_loops_fast(est, grids: WindowGrids, act: np.ndarray,
                       ids: List[int], poses_sel: np.ndarray,
                       valid_sel: np.ndarray):
    """Vectorized anchor + gate + PCM + same-pair averaging.

    Returns dict of anchored-factor arrays (fa, ca, fb, cb, dpose, ps, ys)
    after averaging — the array equivalent of _filter_loops's tuple list.
    """
    from omniswarm_torch.robust.pcm import LoopSet

    p = est.params
    soa = est._loops_soa()
    N = soa["t_a"].shape[0]
    empty = dict(fa=np.zeros(0, np.int64), ca=np.zeros(0, np.int64),
                 fb=np.zeros(0, np.int64), cb=np.zeros(0, np.int64),
                 dpose=np.zeros((0, 4)), ps=np.zeros(0), ys=np.zeros(0))
    if N == 0:
        return empty

    ids_arr = np.asarray(ids, np.int64)
    ca = np.searchsorted(ids_arr, soa["da"])
    cb = np.searchsorted(ids_arr, soa["db"])
    in_a = (ca < ids_arr.size) & (ids_arr[np.clip(ca, 0, ids_arr.size - 1)]
                                  == soa["da"])
    in_b = (cb < ids_arr.size) & (ids_arr[np.clip(cb, 0, ids_arr.size - 1)]
                                  == soa["db"])
    ca = np.clip(ca, 0, max(ids_arr.size - 1, 0))
    cb = np.clip(cb, 0, max(ids_arr.size - 1, 0))

    fa = _nearest_kf_vec(grids, act, soa["t_a"], np.where(in_a, ca, -1))
    fb = _nearest_kf_vec(grids, act, soa["t_b"], np.where(in_b, cb, -1))
    mask = in_a & in_b & (fa >= 0) & (fb >= 0)
    fa_c = np.clip(fa, 0, max(grids.nrows - 1, 0))
    fb_c = np.clip(fb, 0, max(grids.nrows - 1, 0))

    pa_kf = poses_sel[fa_c, ca]
    pb_kf = poses_sel[fb_c, cb]
    mask &= valid_sel[fa_c, ca] & valid_sel[fb_c, cb]
    pa_t, fnd_a = _ego_at_vec(est, soa["da"], soa["t_a"])
    pb_t, fnd_b = _ego_at_vec(est, soa["db"], soa["t_b"])
    mask &= fnd_a & fnd_b

    d_a = delta_pose_np(pa_kf, pa_t)          # kf_a -> capture_a
    d_b = delta_pose_np(pb_t, pb_kf)          # capture_b -> kf_b
    dpose = pose_mul_np(pose_mul_np(d_a, soa["dpose"]), d_b)

    # 6-DoF subset: full-attitude composition, flattened at the end
    # (solver.cpp:1464-1553) — only where all four ego6 lookups resolve
    has6 = soa["has6"]
    if has6.any():
        from omniswarm_torch.core.geometry import (
            se3_delta_np, se3_mul_np, se3_to_pose4_np)

        t_kfa = grids.times[fa_c]
        t_kfb = grids.times[fb_c]
        pa_kf6, f1 = _ego6_at_vec(est, soa["da"], t_kfa)
        pb_kf6, f2 = _ego6_at_vec(est, soa["db"], t_kfb)
        pa_t6, f3 = _ego6_at_vec(est, soa["da"], soa["t_a"])
        pb_t6, f4 = _ego6_at_vec(est, soa["db"], soa["t_b"])
        use6 = has6 & f1 & f2 & f3 & f4
        if use6.any():
            d_a6 = se3_delta_np(pa_kf6, pa_t6)
            d_b6 = se3_delta_np(pb_t6, pb_kf6)
            new6 = se3_mul_np(se3_mul_np(d_a6, soa["dpose6"]), d_b6)
            dp6 = se3_to_pose4_np(new6)
            dp6[..., 3] = wrap(dp6[..., 3])
            dpose = np.where(use6[:, None], dp6, dpose)

    # drift: VIO path length capture<->anchor, chord fallback
    la, la_f = _path_length_vec(est, soa["da"], grids.times[fa_c],
                                soa["t_a"])
    lb, lb_f = _path_length_vec(est, soa["db"], soa["t_b"],
                                grids.times[fb_c])
    chord = (np.linalg.norm(d_a[:, :3], axis=1)
             + np.linalg.norm(d_b[:, :3], axis=1))
    drift = np.maximum(np.where(la_f, la, 0.0) + np.where(lb_f, lb, 0.0),
                       chord)
    mask &= drift <= p.det_dpos_thres
    pv, yv = drift_variances(drift, p.vo_cov_pos_per_meter,
                             p.vo_cov_yaw_per_meter, 0.0)
    ps = np.sqrt(soa["pos_std"] ** 2 + pv)
    ys = np.sqrt(soa["yaw_std"] ** 2 + yv)

    sel = np.flatnonzero(mask)
    if sel.size == 0:
        return empty
    anchored = dict(fa=fa[sel], ca=ca[sel], fb=fb[sel], cb=cb[sel],
                    dpose=dpose[sel], ps=ps[sel], ys=ys[sel])

    if p.debug_no_rejection:
        # ablation parity: raw pass-through, no PCM, no same-pair fusion
        return anchored
    if not p.pcm_enable:
        return _average_same_pair_np(anchored)

    # ---- PCM (batched, INCREMENTAL) + decentralized bookkeeping --------
    # A loop's PCM verdict depends on its pair's anchored loop set and the
    # VIO trajectory between anchor times — both stable in TIME space as
    # the window slides. Verdicts are cached per drone-pair keyed by a
    # signature of (loop keys, anchor keyframe times); only pairs whose
    # signature changed (new loop, eviction-forced re-anchor) re-enter
    # the consistency kernel + max-clique. Steady state at ~1 Hz: one
    # dirty pair per solve instead of the full 2k-loop matrix (the full
    # kernel + bits download alone was ~46 ms of a 117 ms host build).
    keys_all = _loop_keys_vec(soa)[sel]          # (n, 4) canonical rows
    raw_lo = np.minimum(soa["da"], soa["db"])[sel]
    raw_hi = np.maximum(soa["da"], soa["db"])[sel]
    n_anch = sel.size
    t_kfa = np.rint(grids.times[np.clip(anchored["fa"], 0,
                                        grids.nrows - 1)] * 100)
    t_kfb = np.rint(grids.times[np.clip(anchored["fb"], 0,
                                        grids.nrows - 1)] * 100)
    sig = np.concatenate(
        [keys_all, t_kfa[:, None].astype(np.int64),
         t_kfb[:, None].astype(np.int64)], 1)

    cache = getattr(est, "_pcm_pair_cache", None)
    if cache is None:
        cache = est._pcm_pair_cache = {}
    consume_pcm_pending(est)         # results of the previous async launch

    pair_rows: dict = {}
    for i in range(n_anch):
        pair_rows.setdefault((int(raw_lo[i]), int(raw_hi[i])),
                             []).append(i)
    mine = {pair: rows for pair, rows in pair_rows.items()
            if p.pcm_redundant or est.self_id in pair}
    # cold pairs (never classified) must compute synchronously; stale
    # pairs (signature changed since the cached verdicts) serve the OLD
    # verdicts this tick and relaunch the consistency kernel async — it
    # executes while the LM solve runs, and finalize_solve consumes it.
    # One-tick verdict staleness is ordinary eventual consistency here:
    # peer inlier sets already arrive with arbitrary comm delays
    # (swarm_outlier_rejection.cpp:37-56).
    cold_rows, stale_rows = [], []
    pair_sig: dict = {}
    for pair, rows in mine.items():
        rows_a = np.asarray(rows)
        h = hash(sig[rows_a][np.lexsort(sig[rows_a].T[::-1])].tobytes())
        ent = cache.get(pair)
        if ent is not None and ent["h"] == h:
            continue
        pair_sig[pair] = h
        (cold_rows if ent is None else stale_rows).extend(rows)
    # drop cache entries for pairs that vanished from the window
    for pair in [q for q in cache if q not in mine]:
        del cache[pair]

    def _subset_loopset(rows):
        d = np.asarray(sorted(rows))
        sw = anchored["ca"][d] > anchored["cb"][d]
        dp_d = anchored["dpose"][d]
        dp_can = np.where(sw[:, None], _invert_pose_rows(dp_d), dp_d)
        return d, LoopSet(
            frame_a=np.where(sw, anchored["fb"][d],
                             anchored["fa"][d]).astype(np.int32),
            drone_a=np.where(sw, anchored["cb"][d],
                             anchored["ca"][d]).astype(np.int32),
            frame_b=np.where(sw, anchored["fa"][d],
                             anchored["fb"][d]).astype(np.int32),
            drone_b=np.where(sw, anchored["ca"][d],
                             anchored["cb"][d]).astype(np.int32),
            dpose=dp_can.astype(np.float32),
            cov_diag=np.stack(
                [anchored["ps"][d] ** 2] * 3
                + [anchored["ys"][d] ** 2], 1).astype(np.float32))

    from omniswarm_torch.robust.pcm import pcm_finish_all, pcm_launch_all

    vio_grid = None
    if cold_rows:
        vio_grid = _vio_grid_np(poses_sel, valid_sel)
        d, loopset = _subset_loopset(cold_rows)
        res = pcm_finish_all(pcm_launch_all(
            loopset, vio_grid, device=est.device, pcm_thres=p.pcm_thres_4dof,
            vo_cov_pos_per_meter=p.vo_cov_pos_per_meter,
            vo_cov_yaw_per_meter=p.vo_cov_yaw_per_meter))
        for pair in {(int(raw_lo[i]), int(raw_hi[i])) for i in d}:
            cache[pair] = {"h": pair_sig[pair], "good": set()}
        for j in np.flatnonzero(res.good_mask):
            i = int(d[j])
            cache[(int(raw_lo[i]), int(raw_hi[i]))]["good"].add(
                tuple(keys_all[i]))
    if stale_rows:
        if vio_grid is None:
            vio_grid = _vio_grid_np(poses_sel, valid_sel)
        d, loopset = _subset_loopset(stale_rows)
        handle = pcm_launch_all(
            loopset, vio_grid, device=est.device, pcm_thres=p.pcm_thres_4dof,
            vo_cov_pos_per_meter=p.vo_cov_pos_per_meter,
            vo_cov_yaw_per_meter=p.vo_cov_yaw_per_meter)
        est._pcm_pending = {
            "handle": handle,
            "keys": keys_all[d],
            "pairs": [(int(raw_lo[i]), int(raw_hi[i])) for i in d],
            "pair_sig": {q: pair_sig[q] for q in
                         {(int(raw_lo[i]), int(raw_hi[i])) for i in d}},
        }

    est.pair_inliers = {pair: set(ent["good"])
                        for pair, ent in cache.items()}

    good = np.zeros(n_anch, bool)
    for pair, rows in pair_rows.items():
        ent = cache.get(pair)
        if ent is not None:
            gset = ent["good"]
            for i in rows:
                good[i] = tuple(keys_all[i]) in gset
        else:
            # foreign pair (non-redundant mode): adopt the peer-broadcast
            # inlier set, or accept-all when none is known
            ext = est.external_inliers.get(pair)
            if ext is None:
                for i in rows:
                    good[i] = True
            else:
                for i in rows:
                    good[i] = tuple(keys_all[i]) in ext

    keep = np.flatnonzero(good)
    return _average_same_pair_np(
        {k: v[keep] for k, v in anchored.items()})


def _vio_grid_np(poses_sel: np.ndarray, valid_sel: np.ndarray) -> np.ndarray:
    """Vectorized _vio_grid: VIO grid with missing drones forward-filled
    from the previous frame (rows before first appearance stay zero)."""
    F, D = valid_sel.shape
    r = np.arange(F)[:, None]
    last = np.where(valid_sel, r, -1)
    last = np.maximum.accumulate(last, axis=0)
    grid = poses_sel[np.maximum(last, 0), np.arange(D)[None, :]]
    return np.where((last >= 0)[..., None], grid, 0.0).astype(np.float32)


def _average_same_pair_np(a: dict) -> dict:
    """Vectorized _average_same_pair: information-weighted fusion of loops
    joining the same keyframe pair (combined variance = K / sum(1/var) so
    duplicates carry ~one measurement's weight); groups keep
    first-appearance order. Orientation-canonical (b<a edges inverted)."""
    n = a["fa"].shape[0]
    if n == 0:
        return a
    sw = (a["fb"] < a["fa"]) | ((a["fb"] == a["fa"]) & (a["cb"] < a["ca"]))
    key = np.stack([np.where(sw, a["fb"], a["fa"]),
                    np.where(sw, a["cb"], a["ca"]),
                    np.where(sw, a["fa"], a["fb"]),
                    np.where(sw, a["ca"], a["cb"])], 1)
    dpose = np.where(sw[:, None], _invert_pose_rows(a["dpose"]), a["dpose"])
    uniq, first, inv, counts = np.unique(
        key, axis=0, return_index=True, return_inverse=True,
        return_counts=True)
    G = uniq.shape[0]
    if G == n:
        out = dict(a)
        out["dpose"] = dpose
        out["fa"], out["ca"] = key[:, 0], key[:, 1]
        out["fb"], out["cb"] = key[:, 2], key[:, 3]
        return out
    wp = 1.0 / np.maximum(a["ps"], 1e-6) ** 2
    wy = 1.0 / np.maximum(a["ys"], 1e-6) ** 2
    wp_sum = np.zeros(G)
    wy_sum = np.zeros(G)
    pos_sum = np.zeros((G, 3))
    sin_sum = np.zeros(G)
    cos_sum = np.zeros(G)
    np.add.at(wp_sum, inv, wp)
    np.add.at(wy_sum, inv, wy)
    np.add.at(pos_sum, inv, wp[:, None] * dpose[:, :3])
    np.add.at(sin_sum, inv, wy * np.sin(dpose[:, 3]))
    np.add.at(cos_sum, inv, wy * np.cos(dpose[:, 3]))
    dp_out = np.concatenate(
        [pos_sum / wp_sum[:, None],
         np.arctan2(sin_sum, cos_sum)[:, None]], 1)
    ps_out = np.sqrt(counts / wp_sum)
    ys_out = np.sqrt(counts / wy_sum)
    order = np.argsort(first, kind="stable")    # first-appearance order
    return dict(fa=uniq[order, 0], ca=uniq[order, 1],
                fb=uniq[order, 2], cb=uniq[order, 3],
                dpose=dp_out[order], ps=ps_out[order], ys=ys_out[order])


# ---------------------------------------------------------------------------
# Detections (vectorized)
# ---------------------------------------------------------------------------

def _build_detections_fast(est, grids: WindowGrids, act: np.ndarray,
                           ids: List[int], poses_sel: np.ndarray,
                           valid_sel: np.ndarray, Fb: int,
                           yaw_obs=None):
    """Vectorized detection anchoring -> dense (F, D, D) grids.

    Returns (det_dir, det_tb, det_invdep, det_valid, det_depth) or None
    when a detection anchors across frames (the dense layout cannot
    represent it — caller falls back to the generic path, matching
    dense_from_factor_graph's bail-out)."""
    from omniswarm_torch.core import geometry as geo

    p = est.params
    D = len(ids)
    det_dir = np.zeros((Fb, D, D, 3), np.float32)
    det_tb = np.zeros((Fb, D, D, 2, 3), np.float32)
    det_invdep = np.zeros((Fb, D, D), np.float32)
    det_valid = np.zeros((Fb, D, D), bool)
    det_depth = np.zeros((Fb, D, D), bool)
    soa = est._dets_soa()
    N = soa["t"].shape[0]
    if not p.enable_detection or N == 0:
        return det_dir, det_tb, det_invdep, det_valid, det_depth

    ids_arr = np.asarray(ids, np.int64)
    ca = np.searchsorted(ids_arr, soa["da"])
    cb = np.searchsorted(ids_arr, soa["db"])
    in_a = (ca < ids_arr.size) & (ids_arr[np.clip(ca, 0, ids_arr.size - 1)]
                                  == soa["da"])
    in_b = (cb < ids_arr.size) & (ids_arr[np.clip(cb, 0, ids_arr.size - 1)]
                                  == soa["db"])
    ca = np.clip(ca, 0, max(ids_arr.size - 1, 0))
    cb = np.clip(cb, 0, max(ids_arr.size - 1, 0))
    fa = _nearest_kf_vec(grids, act, soa["t"], np.where(in_a, ca, -1))
    fb = _nearest_kf_vec(grids, act, soa["t"], np.where(in_b, cb, -1))
    mask = in_a & in_b & (fa >= 0) & (fb >= 0)
    if yaw_obs is not None:
        # yaw-observability gate, solver.cpp:1066-1068
        obs_ids = np.asarray(sorted(yaw_obs), np.int64)
        mask &= (np.isin(soa["da"], obs_ids)
                 & np.isin(soa["db"], obs_ids))

    # anchor-drift gate (det_dpos_thres, solver.cpp:1527) via the VIO
    # displacement between detection time and the anchor keyframes
    fa_c = np.clip(fa, 0, max(grids.nrows - 1, 0))
    fb_c = np.clip(fb, 0, max(grids.nrows - 1, 0))
    pa_t, fnd_a = _ego_at_vec(est, soa["da"], soa["t"])
    pb_t, fnd_b = _ego_at_vec(est, soa["db"], soa["t"])
    pa_kf = poses_sel[fa_c, ca]
    pb_kf = poses_sel[fb_c, cb]
    kf_ok = valid_sel[fa_c, ca] & valid_sel[fb_c, cb]
    gate_known = fnd_a & fnd_b & kf_ok
    drift = (np.linalg.norm(pa_t[:, :3] - pa_kf[:, :3], axis=1)
             + np.linalg.norm(pb_t[:, :3] - pb_kf[:, :3], axis=1))
    mask &= ~(gate_known & (drift > p.det_dpos_thres))

    sel = np.flatnonzero(mask)
    if sel.size == 0:
        return det_dir, det_tb, det_invdep, det_valid, det_depth
    if np.any(fa[sel] != fb[sel]):
        return None     # cross-frame anchor -> generic fallback

    dirs = soa["direction"][sel].astype(np.float32)
    tb = geo.tangent_base_from_unit_np(dirs)
    f_i, a_i, b_i = fa[sel], ca[sel], cb[sel]
    det_dir[f_i, a_i, b_i] = dirs
    det_tb[f_i, a_i, b_i] = tb
    det_invdep[f_i, a_i, b_i] = soa["inv_dep"][sel]
    det_valid[f_i, a_i, b_i] = True
    det_depth[f_i, a_i, b_i] = (soa["enable_depth"][sel]
                                & p.enable_detection_depth)
    return det_dir, det_tb, det_invdep, det_valid, det_depth


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------

def build_dense_fast(est) -> Optional[tuple]:
    """Vectorized numpy assembly of (DenseGraph, init, idmap).

    Returns None when the window structure doesn't fit the dense frame
    layout (odom-chain gaps, cross-frame detections) — the caller falls
    back to SwarmEstimator._build + dense_from_factor_graph.
    All DenseGraph leaves stay numpy; the solve performs the single
    host->device transfer.
    """
    p = est.params
    g = est._grids
    if g.nrows != len(est.window):
        g.rebuild(est.window)
    act = np.flatnonzero(g.valid.any(0))
    if act.size == 0:
        return None
    ids = [g.ids[c] for c in act]
    idmap = {d: i for i, d in enumerate(ids)}
    F, D = g.nrows, len(ids)
    Fb = est._bucket(F, 8)
    poses_sel = g.poses[:, act]                  # (F, D, 4) f64
    valid_sel = g.valid[:, act]

    pos_obs, yaw_obs, _ = est._estimate_observability()

    # --- pose masks + init ---------------------------------------------
    pose_valid = np.zeros((Fb, D), bool)
    pose_valid[:F] = valid_sel
    pose_fixed = np.zeros((Fb, D), bool)
    yaw_fixed = np.zeros((Fb, D), bool)
    self_col = idmap.get(est.self_id)
    if self_col is not None and valid_sel[:, self_col].any():
        pose_fixed[np.flatnonzero(valid_sel[:, self_col])[0], self_col] = True
    for di, d in enumerate(ids):
        if d not in pos_obs:
            # completely unobservable drone frozen at VIO (solver.cpp:1122)
            pose_fixed[:F, di] |= valid_sel[:, di]
        elif d not in yaw_obs:
            # motion-init-only drone: yaw column frozen (the masked-grid
            # form of the yaw_observability guard, solver.cpp:1066,:1413)
            yaw_fixed[:F, di] = valid_sel[:, di]
    init = np.zeros((Fb, D, 4), np.float32)
    init[:F] = np.where(valid_sel[..., None], poses_sel, 0.0)

    # --- ego-motion chains ---------------------------------------------
    odom_dpose = np.zeros((max(Fb - 1, 1), D, 4), np.float32)
    odom_si = np.zeros((max(Fb - 1, 1), D, 4), np.float32)
    odom_valid = np.zeros((max(Fb - 1, 1), D), bool)
    for di, d in enumerate(ids):
        nc = est.node_configs.get(d)
        is_static = nc is not None and nc.is_static
        has_vo = nc is None or nc.has_vo
        if not (is_static or has_vo):
            continue        # no motion information — floats on ranges/loops
        vf = np.flatnonzero(valid_sel[:, di])
        if vf.size < 2:
            continue
        if vf[-1] - vf[0] != vf.size - 1:
            return None     # chain gap -> dense layout can't represent
        a = vf[:-1]
        if is_static:
            # zero-motion prior for stationary anchors (solver.cpp:291-295)
            odom_si[a, di] = 1e3
            odom_valid[a, di] = True
        else:
            dp = delta_pose_np(poses_sel[a, di], poses_sel[a + 1, di])
            seg = np.maximum(np.linalg.norm(dp[:, :3], axis=1), 1e-3)
            odom_dpose[a, di] = dp
            odom_si[a, di, :3] = (1.0 / np.sqrt(
                p.vo_cov_pos_per_meter * seg))[:, None]
            odom_si[a, di, 3] = 1.0 / np.sqrt(p.vo_cov_yaw_per_meter * seg)
            odom_valid[a, di] = True

    # --- UWB ranges + vectorized gating --------------------------------
    range_dist = np.zeros((Fb, D, D), np.float32)
    range_si = np.zeros((Fb, D, D), np.float32)
    range_valid = np.zeros((Fb, D, D), bool)
    if p.enable_distance:
        dist = g.rng_dist[:, act][:, :, act]
        rv = g.rng_valid[:, act][:, :, act] & (dist >= p.minimum_distance)
        e = est.estimate
        if e is not None and len(e):
            # estimate-based outlier gate (outlier_rejection_frame,
            # solver.cpp:408-515) — indexes the estimate with CURRENT
            # columns, matching _range_outlier's behavior
            Fe, De = min(len(e), F), min(e.shape[1], D)
            ea = e[:Fe, :De]
            finite = np.isfinite(ea).all(-1)
            dvec = ea[:, :, None, :3] - ea[:, None, :, :3]
            d_est = np.linalg.norm(dvec, axis=-1)
            dz = np.abs(ea[:, :, None, 2] - ea[:, None, :, 2])
            ds = dist[:Fe, :De, :De]
            out1 = np.abs(d_est - ds) > np.maximum(
                p.distance_outlier_threshold * d_est, 1.0)
            elev = dz / np.maximum(d_est, 1e-6)
            out2 = (elev > p.distance_outlier_elevation_threshold) & (ds < 3.0)
            outlier = (finite[:, :, None] & finite[:, None, :]
                       & (d_est >= 1e-6) & (out1 | out2))
            rv[:Fe, :De, :De] &= ~outlier
        if p.cutting_edges and F > 1:
            # cutting_edges (solver.cpp:1225-1296): prune ranges whose
            # endpoints BOTH moved < not_moving_thres since the previous
            # frame and whose pair already measured there — a static
            # stretch collapses to its first frame (vectorized form of
            # the estimator._build pruning; raw presence, pre-gating)
            pos3 = poses_sel[..., :3]
            step = np.linalg.norm(pos3[1:] - pos3[:-1], axis=-1)
            moved = ((step > p.not_moving_thres)
                     | ~valid_sel[1:] | ~valid_sel[:-1])       # (F-1, D)
            raw = g.rng_valid[:, act][:, :, act]
            prev = raw[:-1] | raw[:-1].transpose(0, 2, 1)
            redundant = (~moved[:, :, None] & ~moved[:, None, :] & prev)
            rv[1:] &= ~redundant
        range_dist[:F] = np.where(rv, dist, 0.0)
        range_si[:F] = np.where(
            rv, 1.0 / np.sqrt(p.distance_measurement_cov), 0.0)
        range_valid[:F] = rv

    # --- loops (anchor + PCM + averaging) ------------------------------
    Lb = est._bucket(len(est.loops) + len(est.dets), 64)
    good = _filter_loops_fast(est, g, act, ids, poses_sel, valid_sel)
    # yaw-observability gate (solver.cpp:1066-1068): drop edges whose
    # endpoints are disconnected from self's loop graph
    col_yaw_obs = np.asarray([d in yaw_obs for d in ids], bool)
    keep = col_yaw_obs[good["ca"]] & col_yaw_obs[good["cb"]]
    if not keep.all():
        good = {k: v[keep] for k, v in good.items()}
    n = good["fa"].shape[0]
    if n > Lb:
        return None         # capacity anomaly — let the slow path assert
    lp_fa = np.zeros(Lb, np.int32)
    lp_da = np.zeros(Lb, np.int32)
    lp_fb = np.zeros(Lb, np.int32)
    lp_db = np.zeros(Lb, np.int32)
    lp_dp = np.zeros((Lb, 4), np.float32)
    lp_si = np.zeros((Lb, 4, 4), np.float32)
    lp_v = np.zeros(Lb, bool)
    if n:
        lp_fa[:n], lp_da[:n] = good["fa"], good["ca"]
        lp_fb[:n], lp_db[:n] = good["fb"], good["cb"]
        lp_dp[:n] = good["dpose"]
        inv_ps = 1.0 / good["ps"]
        inv_ys = 1.0 / good["ys"]
        lp_si[:n, 0, 0] = inv_ps
        lp_si[:n, 1, 1] = inv_ps
        lp_si[:n, 2, 2] = inv_ps
        lp_si[:n, 3, 3] = inv_ys
        lp_v[:n] = True
    loops = RelPoseFactors(lp_fa, lp_da, lp_fb, lp_db, lp_dp, lp_si, lp_v)

    # --- detections -----------------------------------------------------
    dets = _build_detections_fast(est, g, act, ids, poses_sel, valid_sel,
                                  Fb, yaw_obs=yaw_obs)
    if dets is None:
        return None
    det_dir, det_tb, det_invdep, det_valid, det_depth = dets
    if not det_valid.any():
        # det grids are >half the graph's bytes at large F and all-zero
        # without detections: None skips both the upload and the term math
        # (assemble_* gate on det_dir is not None)
        det_dir = det_tb = det_invdep = det_valid = det_depth = None

    # --- antenna offsets ------------------------------------------------
    ant = None
    for di, d in enumerate(ids):
        nc = est.node_configs.get(d)
        if nc is not None and any(abs(x) > 1e-9 for x in nc.antenna_pos):
            if ant is None:
                ant = np.zeros((D, 3), np.float32)
            ant[di] = np.asarray(nc.antenna_pos, np.float32)

    graph = DenseGraph(
        range_dist=range_dist, range_valid=range_valid,
        range_sqrt_inf=range_si,
        odom_dpose=odom_dpose, odom_sqrt_info=odom_si,
        odom_valid=odom_valid,
        det_dir=det_dir, det_tb=det_tb, det_invdep=det_invdep,
        det_valid=det_valid, det_has_depth=det_depth,
        loops=loops,
        pose_valid=pose_valid, pose_fixed=pose_fixed,
        yaw_fixed=yaw_fixed,
        ant_pos=ant,
    )
    return graph, init, idmap
