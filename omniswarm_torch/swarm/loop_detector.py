"""Loop recognition and geometric verification.

Counterpart of ``omniswarm_tpu/swarm/loop_detector.py`` (:55-785). On every
keyframe (local, or received from a peer over LoopNet):

1. query the place-recognition databases, split local / remote as the
   reference's two indices: a remote keyframe queries the local DB; a self
   keyframe queries the local DB (with the ``match_index_dist`` recency
   guard) and the remote DB; a self non-keyframe queries the remote DB only;
2. per-mode thresholds: an inter-drone pair with fewer than
   ``inter_drone_init_frames`` accepted loops is in init mode, with the
   relaxed similarity gate and inlier minimum;
3. mutual-NN match the local descriptors, pre-filter the matches with
   homography RANSAC in pixel space, and solve the 4-DoF relative pose by
   PnP RANSAC (``ops/homography``, ``ops/ransac``);
4. host gates: inlier count, relative-pose magnitude and yaw, and the
   covariance-scaled intra-drone odometry-consistency gate;
5. add the keyframe to its database (unless ``prevent_adding_db``).

``on_keyframes_batch`` is the serving tick (``verify_batch``, the default):
retrieval over both databases, the ring inserts of descriptors and packed
landmark payloads, the candidate merge and the verification of every
(query, candidate) lane run as plain torch ops on the device, followed by
ONE host read of the outputs. Payloads are packed on the host as f16 with
the reference's code, so both packages round alike, and upcast to f32 on
the device. The query axis is bucketed to 1 or a multiple of 4 and the
candidate axis is ``2 k`` lanes under ``balanced_db_candidates`` (else
``min(k, 2 k)``), as in the reference, so a tick's lanes and random draws
line up with the reference's.

All of a tick's random draws come from ``tick_noise(tick_seed, Qb, C, Kb)``
(``walk_noise(Kb)`` for the ``verify_batch=False`` walk): Gumbel noise from
a ``torch.Generator`` seeded by the tick's seed. A test replaces the method
with JAX's draw for the reference's keys and then gets the reference's
hypotheses. ``match_viz_dir`` needs ``eval/match_viz.py``, which is not
ported yet: setting it raises (and ``register_image``, which only feeds
it, is left out).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from omniswarm_torch.config import FrontendParams
from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.core.precision import highp
from omniswarm_torch.ops import placedb
from omniswarm_torch.ops.homography import homography_ransac
from omniswarm_torch.ops.matching import mutual_match
from omniswarm_torch.ops.ransac import _norm, gumbel_noise, pnp_ransac_4dof
from omniswarm_torch.sim.simulator import delta_pose_np, wrap
from omniswarm_torch.swarm.comm import KeyframeData, LoopEdgePacket

HOM_HYPOTHESES = 256     # homography_ransac's default; the verify never sets it


def _verify(desc_a, valid_a, kp_a, p3d_a, desc_b, valid_b, kp_b, p3d_b,
            hom_noise: Optional[torch.Tensor], pnp_noise: torch.Tensor, *,
            pnp_err: float, hom_err: float):
    """Geometric verification of B lanes (reference ``_verify_body``):
    mutual matching, the optional homography pre-filter, 4-DoF PnP RANSAC.
    Every input has a leading lane axis; hom_noise is None without the
    pre-filter. Returns (idx_b, raw_mask, mask, n_match, n_valid, dpose,
    n_inliers, inliers)."""
    m = mutual_match(desc_a, desc_b, valid_a, valid_b, min_similarity=0.5)
    gather = lambda x: torch.gather(
        x, 1, m.idx_b[..., None].expand(-1, -1, x.shape[-1]))
    n_match = m.mask.sum(-1)
    mask = m.mask
    if hom_noise is not None:
        h = homography_ransac(kp_a, gather(kp_b), m.mask, hom_noise,
                              err_thresh=hom_err)
        # filter only when one homography explains most matches: distorted
        # pixels are not homography-related even for planar scenes
        keep = (h.num_inliers >= 8) & (h.num_inliers >= 0.5 * n_match)
        mask = torch.where(keep[:, None], m.mask & h.inliers, m.mask)
    old_p3d = gather(p3d_b)
    norms = _norm(old_p3d)
    bearings = old_p3d / torch.clamp(norms[..., None], min=1e-6)
    valid = (mask & (norms > 1e-3)
             & (_norm(p3d_a) > 1e-3))
    res = pnp_ransac_4dof(p3d_a, bearings, valid, pnp_noise,
                          err_thresh=pnp_err)
    return (m.idx_b, m.mask, mask, n_match, valid.sum(-1), res.dpose,
            res.num_inliers, res.inliers)


def _unpack(packed: torch.Tensor):
    """(..., Kb, Cdim+6) packed rows -> (desc, valid, kp, p3d)."""
    cdim = packed.shape[-1] - 6
    return (packed[..., :cdim], packed[..., cdim] > 0.5,
            packed[..., cdim + 1:cdim + 3], packed[..., cdim + 3:cdim + 6])


def _download(*tensors: torch.Tensor) -> List[np.ndarray]:
    """One device-to-host read of several tensors (each small-integer,
    bool or f32): flattened into one f32 buffer, split and re-typed on the
    host."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    buf = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        a = buf[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
        if t.dtype == torch.bool:
            a = a > 0.5
        elif not t.dtype.is_floating_point:
            a = a.astype(np.int64)
        out.append(a)
    return out


@dataclass
class LoopCandidate:
    edge: LoopEdgePacket
    num_inliers: int
    similarity: float


class LoopDetector:
    """One drone's loop detector, on ``device`` (the GPU unless the CPU is
    asked for).

    ``ticks`` records each serving tick as (verify lanes, host ms around
    the synchronised tick).
    """

    def __init__(self, self_id: int, params: Optional[FrontendParams] = None,
                 *, global_dim: int = 4096, seed: int = 0,
                 match_viz_dir: Optional[str] = None,
                 device="cuda"):
        if match_viz_dir is not None:
            raise NotImplementedError(
                "match_viz_dir needs eval/match_viz.py, which the port "
                "gains with its evaluation slice (slice 6)")
        self.device = resolve_device(device)
        self.self_id = self_id
        self.p = params or FrontendParams()
        # local vs remote descriptor databases
        self.local_db = placedb.make_placedb(self.p.max_db_size, global_dim,
                                             self.device)
        self.remote_db = placedb.make_placedb(self.p.max_db_size,
                                              global_dim, self.device)
        self.local_kfs: Dict[int, KeyframeData] = {}   # slot -> keyframe
        self.remote_kfs: Dict[int, KeyframeData] = {}
        self._local_count = 0
        self._remote_count = 0
        self.pair_loop_count: Dict[Tuple[int, int], int] = {}
        # landmark-payload rings (N, Kb, Cdim+6) f16, sized on first batch
        self._pay_local: Optional[torch.Tensor] = None
        self._pay_remote: Optional[torch.Tensor] = None
        # seed base of the ticks' draws (the reference's, so that a test
        # can derive the reference's keys from a tick's seed)
        self._seed0 = (seed * 1_000_003 + 12345) & 0x7FFFFFFF
        self._seed_counter = 0
        self._walk_counter = 0
        self.num_queries = 0
        self.num_loops = 0
        self.ticks: List[Tuple[int, float]] = []

    # ------------------------------------------------------------------
    # random draws
    # ------------------------------------------------------------------
    def _noise(self, seed: int, lanes: int, Kb: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        hom = (gumbel_noise((lanes, HOM_HYPOTHESES, 4, Kb), g, self.device)
               if self.p.homography_prefilter else None)
        pnp = gumbel_noise((lanes, self.p.pnp_iterations, 4, Kb), g,
                           self.device)
        return hom, pnp

    def tick_noise(self, tick_seed: int, Qb: int, C: int, Kb: int):
        """Gumbel noise of one serving tick, lane-major (query, candidate):
        (homography (Qb*C, 256, 4, Kb) or None, PnP (Qb*C, pnp_iterations,
        4, Kb))."""
        return self._noise(tick_seed, Qb * C, Kb)

    def walk_noise(self, Kb: int):
        """Gumbel noise of one candidate of the ``verify_batch=False`` walk
        (one lane); each call advances the walk's stream."""
        self._walk_counter += 1
        return self._noise((self._seed0 << 24) + self._walk_counter, 1, Kb)

    # ------------------------------------------------------------------
    def _init_mode(self, remote_drone: int) -> bool:
        """Relaxed-gate mode until the pair with self has enough loops."""
        if remote_drone == self.self_id:
            return False
        pair = (min(remote_drone, self.self_id),
                max(remote_drone, self.self_id))
        return self.pair_loop_count.get(pair, 0) \
            < self.p.inter_drone_init_frames

    def _thresholds(self, init_mode: bool) -> Tuple[float, int]:
        if init_mode:
            return self.p.netvlad_init_thres, self.p.min_loop_matches_init
        return self.p.netvlad_thres, self.p.min_loop_matches

    def _gates(self, kf: KeyframeData, old: KeyframeData,
               sim: float) -> Optional[int]:
        """The inlier minimum a candidate must reach, or None when its
        similarity rules it out (with the geometric override)."""
        init_mode = self._init_mode(
            old.drone_id if kf.drone_id == self.self_id else kf.drone_id)
        thres, min_inliers = self._thresholds(init_mode)
        if sim < thres:
            # geometric override: strong PnP support overrules a weak
            # retrieval score
            if self.p.geometric_override_matches <= 0:
                return None
            min_inliers = max(min_inliers, self.p.geometric_override_matches)
        return min_inliers

    def _count_loops(self, results) -> None:
        for result in results:
            pair = (min(result.edge.drone_a, result.edge.drone_b),
                    max(result.edge.drone_a, result.edge.drone_b))
            self.pair_loop_count[pair] = self.pair_loop_count.get(pair, 0) + 1
            self.num_loops += 1

    def on_keyframe(self, kf: KeyframeData, prevent_adding_db: bool = False
                    ) -> Optional[LoopCandidate]:
        """Process one keyframe (query, verify, add to its DB); the best
        accepted loop or None."""
        results = self.on_keyframe_multi(
            kf, prevent_adding_db=prevent_adding_db)
        return results[0] if results else None

    def on_keyframe_multi(self, kf: KeyframeData,
                          prevent_adding_db: bool = False) -> list:
        """Process one keyframe, returning all accepted loop candidates
        (at most ``max_loops_per_query``)."""
        if self.p.verify_batch:
            return self.on_keyframes_batch([kf], [prevent_adding_db])[0]
        results = self._query_and_verify(kf, nonkeyframe=prevent_adding_db)
        # add after the query, so that a frame never matches itself
        if not prevent_adding_db:
            desc = torch.as_tensor(np.asarray(kf.global_desc, np.float32),
                                   device=self.device)
            if kf.drone_id == self.self_id:
                self.local_kfs[self._local_count % self.p.max_db_size] = kf
                self.local_db = placedb.add(self.local_db, desc,
                                            kf.drone_id, kf.frame_id)
                self._local_count += 1
            else:
                self.remote_kfs[self._remote_count % self.p.max_db_size] = kf
                self.remote_db = placedb.add(self.remote_db, desc,
                                             kf.drone_id, kf.frame_id)
                self._remote_count += 1
        self._count_loops(results)
        return results

    # ------------------------------------------------------------------
    def on_keyframes_batch(self, kfs, prevent_flags=None) -> list:
        """Process many keyframes as one serving tick.

        Retrieval over both databases for every keyframe (the databases as
        they were before the batch), the batch's ring inserts, the merge of
        the candidates and the verification of every (keyframe, candidate)
        lane run on the device; one host read brings back the outputs,
        then the host gates walk each keyframe's candidates strongest
        geometry first. Returns a list of lists of accepted
        LoopCandidates aligned with ``kfs``.
        """
        p = self.p
        if prevent_flags is None:
            prevent_flags = [False] * len(kfs)
        if not kfs:
            return []
        if not p.verify_batch:
            return [self.on_keyframe_multi(kf, prevent_adding_db=pr)
                    for kf, pr in zip(kfs, prevent_flags)]
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        n = len(kfs)
        # the query axis: 1, or a multiple of 4
        Qb = 1 if n == 1 else ((n + 3) // 4) * 4
        G = int(np.asarray(kfs[0].global_desc).shape[0])
        descs = np.zeros((Qb, G), np.float32)
        metas = np.full((Qb, 4), 1, np.int64)
        metas[:, 0] = -999                   # pad rows match nothing
        metas[:, 1] = -1
        add_sel = np.zeros(Qb, np.int64)
        use_ab = np.zeros((Qb, 2), bool)
        for i, (kf, pr) in enumerate(zip(kfs, prevent_flags)):
            self.num_queries += 1
            descs[i] = kf.global_desc
            metas[i] = (kf.drone_id, kf.frame_id, 1, 1)
            if kf.drone_id != self.self_id:
                # remote keyframe: match against our keyframes only
                use_ab[i, 0] = self._local_count > 0
                if not pr:
                    add_sel[i] = 2
            elif pr:
                # self non-keyframe: match against remote keyframes only
                use_ab[i, 1] = self._remote_count > 0
            else:
                metas[i, 2] = p.match_index_dist
                use_ab[i, 0] = self._local_count > 0
                use_ab[i, 1] = self._remote_count > 0
                add_sel[i] = 1

        Cdim = int(kfs[0].local_desc.shape[1])
        P = Cdim + 6
        if self._pay_local is None:
            Kb = max(p.max_keypoints,
                     max(int(kf.local_desc.shape[0]) for kf in kfs))
            Kb = ((Kb + 63) // 64) * 64
            shape = (p.max_db_size, Kb, P)
            self._pay_local = torch.zeros(shape, dtype=torch.float16,
                                          device=dev)
            self._pay_remote = torch.zeros(shape, dtype=torch.float16,
                                           device=dev)
        Kb = int(self._pay_local.shape[1])

        def pack16(o, out):
            kk = min(int(o.local_desc.shape[0]), Kb)
            out[:kk, :Cdim] = o.local_desc[:kk]
            out[:kk, Cdim] = o.valid[:kk]
            out[:kk, Cdim + 1:Cdim + 3] = o.kp_xy[:kk]
            out[:kk, Cdim + 3:Cdim + 6] = o.landmarks_3d[:kk]
            return out

        qpacks = np.zeros((Qb, Kb, P), np.float16)
        for i, kf in enumerate(kfs):
            pack16(kf, qpacks[i])

        # slots this batch overwrites: their ring payload now belongs to
        # the new keyframe, so a candidate pointing at one is dropped
        cap = p.max_db_size
        over_a = np.zeros(cap, bool)
        over_b = np.zeros(cap, bool)
        for r in range(int((add_sel == 1).sum())):
            if self._local_count + r >= cap:
                over_a[(self._local_count + r) % cap] = True
        for r in range(int((add_sel == 2).sum())):
            if self._remote_count + r >= cap:
                over_b[(self._remote_count + r) % cap] = True
        floor = min(p.netvlad_thres, p.netvlad_init_thres)

        self._seed_counter += 1
        k = min(p.search_nearest_num, cap)
        C = 2 * k if p.balanced_db_candidates else min(k, 2 * k)
        noise = self.tick_noise(self._seed0 + self._seed_counter, Qb, C, Kb)
        to_dev = lambda a: torch.from_numpy(a).to(dev)
        with highp(), torch.no_grad():
            out = self._tick(to_dev(descs), to_dev(metas), add_sel,
                             to_dev(qpacks), to_dev(use_ab), floor,
                             to_dev(over_a), to_dev(over_b), noise, k, C)
            with record_function("detector/download"):
                (src, slot, sim_qc, idx_b, mask, n_match, n_valid, dpose,
                 n_inl, inliers) = _download(*out)

        # commit the inserts to the host slot maps
        for i, kf in enumerate(kfs):
            if add_sel[i] == 1:
                self.local_kfs[self._local_count % cap] = kf
                self._local_count += 1
            elif add_sel[i] == 2:
                self.remote_kfs[self._remote_count % cap] = kf
                self._remote_count += 1

        with record_function("detector/host_gates"):
            results = self._walk_tick(kfs, src, slot, sim_qc, idx_b, mask,
                                      n_match, n_valid, dpose, n_inl,
                                      inliers)
        self.ticks.append((Qb * C, (time.perf_counter() - t0) * 1e3))
        return results

    def _tick(self, descs, metas, add_sel, qpacks, use_ab, floor: float,
              over_a, over_b, noise, k: int, C: int):
        """The device half of a serving tick (reference ``_tick_kernel``):
        retrieval, the ring inserts, the candidate merge (floor, per-query
        DB use, overwritten slots masked to -inf; a stable descending sort,
        whose ties keep the lower lane as ``lax.top_k`` does) and the
        gathered verification. Padded candidate lanes have src -1 and zero
        payloads."""
        with record_function("detector/retrieval"):
            ia, sa, ib, sb, na, nb, pa2, pb2 = \
                placedb.query2_add_payload_batch(
                    self.local_db, self.remote_db, self._pay_local,
                    self._pay_remote, descs, metas, add_sel, qpacks, k=k)
            self.local_db, self.remote_db = na, nb
            self._pay_local, self._pay_remote = pa2, pb2
            kk = ia.shape[1]
            ninf = float("-inf")
            sa = torch.where(use_ab[:, 0:1] & (sa >= floor) & ~over_a[ia],
                             sa, ninf)
            sb = torch.where(use_ab[:, 1:2] & (sb >= floor) & ~over_b[ib],
                             sb, ninf)
            sims = torch.cat([sa, sb], 1)                    # (Q, 2k)
            top_sim, pos = torch.sort(sims, dim=1, descending=True,
                                      stable=True)
            top_sim, pos = top_sim[:, :C], pos[:, :C]
            remote = pos >= kk
            slot = torch.where(
                remote, torch.gather(ib, 1, torch.clamp(pos - kk, min=0)),
                torch.gather(ia, 1, torch.clamp(pos, max=kk - 1)))
            src = torch.where(torch.isfinite(top_sim), remote.long(), -1)
        with record_function("detector/verify"):
            N = pa2.shape[0]
            store = torch.cat([pa2, pb2], 0)                 # (2N, Kb, P)
            gidx = torch.clamp(slot + torch.clamp(src, min=0) * N, 0,
                               2 * N - 1)
            cpacks = torch.where((src >= 0)[..., None, None], store[gidx],
                                 0).to(torch.float32)        # (Q, C, Kb, P)
            Q = qpacks.shape[0]
            qp = qpacks.to(torch.float32)[:, None].expand(
                -1, C, -1, -1)
            lanes = lambda x: x.reshape((Q * C,) + tuple(x.shape[2:]))
            hom, pnp = noise
            (idx_b, _raw, mask, n_match, n_valid, dpose, n_inl,
             inliers) = _verify(
                *(lanes(x) for x in _unpack(qp)),
                *(lanes(x) for x in _unpack(cpacks)), hom, pnp,
                pnp_err=self.p.pnp_reproj_err,
                hom_err=self.p.homography_thresh_px)
            per_q = lambda x: x.reshape((Q, C) + tuple(x.shape[1:]))
            return (src, slot, top_sim, per_q(idx_b), per_q(mask),
                    per_q(n_match), per_q(n_valid), per_q(dpose),
                    per_q(n_inl), per_q(inliers))

    def _walk_tick(self, kfs, src, slot, sim_qc, idx_b, mask, n_match,
                   n_valid, dpose, n_inl, inliers) -> list:
        """The host gates of a tick, keyframe by keyframe: every candidate
        is already verified, so the walk takes them by PnP inlier count
        (under aliasing similarity mis-ranks lookalikes, geometry does
        not) and keeps up to ``max_loops_per_query``."""
        p = self.p
        results = [[] for _ in kfs]
        cand_lists = []
        for i in range(len(kfs)):
            cands = []
            for c in range(src.shape[1]):
                if src[i, c] < 0:
                    continue
                d = self.local_kfs if src[i, c] == 0 else self.remote_kfs
                old = d.get(int(slot[i, c]))
                if old is not None:
                    cands.append((old, float(sim_qc[i, c]), c))
            cand_lists.append(cands)
        if not any(cand_lists):
            return results
        for i, kf in enumerate(kfs):
            accepted = []
            order = sorted(cand_lists[i], key=lambda t: -int(n_inl[i, t[2]]))
            for old, sim, c in order:
                min_inliers = self._gates(kf, old, sim)
                if min_inliers is None:
                    continue
                if (int(n_match[i, c]) < min_inliers
                        or int(n_valid[i, c]) < min_inliers):
                    continue
                cand = self._accept_candidate(
                    kf, old, float(sim), min_inliers, dpose[i, c],
                    int(n_inl[i, c]))
                if cand is not None:
                    accepted.append(cand)
                    if len(accepted) >= p.max_loops_per_query:
                        break
            self._count_loops(accepted)
            results[i] = accepted
        return results

    # ------------------------------------------------------------------
    # the verify_batch=False walk
    # ------------------------------------------------------------------
    def _candidates(self, kf: KeyframeData, nonkeyframe: bool):
        """(keyframe, similarity) candidates best first, by the routing
        rules, from one two-database top-k query."""
        k = self.p.search_nearest_num
        if kf.drone_id != self.self_id:
            use_local, use_remote, guard_l = True, False, 1
        elif nonkeyframe:
            use_local, use_remote, guard_l = False, True, 1
        else:
            use_local, use_remote = True, True
            guard_l = self.p.match_index_dist
        use_local = use_local and self._local_count > 0
        use_remote = use_remote and self._remote_count > 0
        if not (use_local or use_remote):
            return []
        desc = torch.as_tensor(np.asarray(kf.global_desc, np.float32),
                               device=self.device)
        il, sl, ir, sr = _download(*placedb.query_topk2(
            self.local_db, self.remote_db, desc,
            [kf.drone_id, kf.frame_id, guard_l, 1], k=k))
        out = []
        if use_local:
            for i, s in zip(il, sl):
                if np.isfinite(s) and int(i) in self.local_kfs:
                    out.append((self.local_kfs[int(i)], float(s)))
        if use_remote:
            for i, s in zip(ir, sr):
                if np.isfinite(s) and int(i) in self.remote_kfs:
                    out.append((self.remote_kfs[int(i)], float(s)))
        out.sort(key=lambda t: -t[1])
        return out[:k]

    def _query_and_verify(self, kf: KeyframeData,
                          nonkeyframe: bool = False) -> list:
        """The reference's walk (verify_batch=False): candidates best
        similarity first, one verification each, stopping at the first
        accepted loop."""
        self.num_queries += 1
        cands = self._candidates(kf, nonkeyframe)
        floor = min(self.p.netvlad_thres, self.p.netvlad_init_thres)
        cands = [(old, sim) for old, sim in cands if sim >= floor]
        if not cands:
            return []
        # one landmark capacity for the query and every candidate
        Kb = max(int(old.local_desc.shape[0]) for old, _ in cands)
        Kb = max(Kb, int(kf.local_desc.shape[0]), self.p.max_keypoints)
        Kb = ((Kb + 63) // 64) * 64
        Cdim = int(cands[0][0].local_desc.shape[1])
        dev = self.device

        def pad(o):
            kk = o.local_desc.shape[0]
            pk = np.zeros((Kb, Cdim + 6), np.float32)
            pk[:kk, :Cdim] = o.local_desc
            pk[:kk, Cdim] = o.valid
            pk[:kk, Cdim + 1:Cdim + 3] = o.kp_xy
            pk[:kk, Cdim + 3:] = o.landmarks_3d
            return _unpack(torch.from_numpy(pk).to(dev)[None])

        query = pad(kf)
        for old, sim in cands:
            min_inliers = self._gates(kf, old, sim)
            if min_inliers is None:
                continue
            hom, pnp = self.walk_noise(Kb)
            with highp(), torch.no_grad():
                out = _verify(*query, *pad(old), hom, pnp,
                              pnp_err=self.p.pnp_reproj_err,
                              hom_err=self.p.homography_thresh_px)
            (_idx_b, _raw, _mask, n_match, n_valid, dpose, n_inl,
             _inliers) = _download(*out)
            if int(n_match[0]) < min_inliers or int(n_valid[0]) < min_inliers:
                continue
            cand = self._accept_candidate(kf, old, float(sim), min_inliers,
                                          dpose[0], int(n_inl[0]))
            if cand is not None:
                return [cand]
        return []

    # ------------------------------------------------------------------
    def _accept_candidate(self, kf: KeyframeData, old: KeyframeData,
                          sim: float, min_inliers: int, dpose_new_in_old,
                          n_inl: int) -> Optional[LoopCandidate]:
        """Host gates on one verified candidate: inliers, relative yaw
        (modulo ``accept_loop_yaw_mod``) and position, odometry
        consistency."""
        if n_inl < min_inliers:
            return None
        dyaw = wrap(dpose_new_in_old[3])
        if self.p.accept_loop_yaw_mod > 0:
            mod = self.p.accept_loop_yaw_mod
            dyaw = dyaw - mod * np.round(dyaw / mod)
        if abs(np.degrees(dyaw)) > self.p.accept_loop_max_yaw:
            return None
        if np.linalg.norm(dpose_new_in_old[:3]) > self.p.accept_loop_max_pos:
            return None

        # the loop edge: relative pose of NEW (a) as seen from OLD (b),
        # emitted a -> b with dpose = a^-1 b, the inverse of (new in old)
        c, s = np.cos(-dpose_new_in_old[3]), np.sin(-dpose_new_in_old[3])
        t = -np.array([
            c * dpose_new_in_old[0] - s * dpose_new_in_old[1],
            s * dpose_new_in_old[0] + c * dpose_new_in_old[1],
            dpose_new_in_old[2]])
        dpose_a_to_b = np.concatenate([t, [wrap(-dpose_new_in_old[3])]])

        if not self._odometry_consistent(kf, old, dpose_a_to_b):
            return None
        edge = LoopEdgePacket(
            drone_a=kf.drone_id, t_a=kf.t,
            drone_b=old.drone_id, t_b=old.t,
            dpose=dpose_a_to_b.astype(np.float32),
            pos_std=float(np.sqrt(self.p.loop_cov_pos)),
            yaw_std=float(np.sqrt(self.p.loop_cov_ang)))
        return LoopCandidate(edge=edge, num_inliers=n_inl, similarity=sim)

    def _odometry_consistent(self, kf: KeyframeData, old: KeyframeData,
                             dpose_a_to_b: np.ndarray) -> bool:
        """Covariance-scaled intra-drone odometry-consistency gate: the
        squared Mahalanobis distance of (loop - VIO relative pose) under
        drift covariance (per metre of path) plus the loop's own, per DoF,
        against ``odometry_consistency_threshold``. Inter-drone loops pass.
        """
        if kf.drone_id != old.drone_id:
            return True
        p = self.p
        odo = delta_pose_np(np.asarray(kf.pose), np.asarray(old.pose))
        dp = odo - dpose_a_to_b
        dp[3] = wrap(dp[3])
        length = max(float(np.linalg.norm(odo[:3])), 0.1)
        cov_pos = p.pos_covariance_per_meter * length + p.loop_cov_pos
        cov_yaw = p.yaw_covariance_per_meter * length + p.loop_cov_ang
        md = float(np.sum(dp[:3] ** 2) / cov_pos + dp[3] ** 2 / cov_yaw)
        return md / 4.0 <= p.odometry_consistency_threshold
