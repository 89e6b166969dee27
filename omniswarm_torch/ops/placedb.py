"""Place-recognition database: a fixed-capacity descriptor matrix.

Counterpart of ``omniswarm_tpu/ops/placedb.py`` (:19-204).
Global descriptors live in an (N, D) ring on the device; a query is a
matvec with masks for validity and the recency guard (entries of the
querying drone within ``match_index_dist`` keyframes of the query are
excluded, MATCH_INDEX_DIST). ``query`` and ``query_batch`` run K3
(``ops/frontend_kernels.retrieval_top1``), one launch per call;
``query_topk`` and ``query_topk2`` rank with a stable descending sort, so
equal similarities (the -inf of masked entries included) keep the lower
index first, as ``jax.lax.top_k`` does.

Unlike the reference's functional update, ``add`` writes the slot in place
(the DB is 64 MB at the default 4096 x 4096) and returns the PlaceDB with
the cursor advanced; the cursor is a Python int, so an insert needs no
device read. The batched ``query2_add_batch`` and
``query2_add_payload_batch`` (the loop detector's tick) therefore run all
of a batch's queries before any of its inserts, which is the reference's
order too: batch members do not see each other.

``query_batch`` and ``add`` carry ``torch.profiler`` ranges,
``placedb/query`` (the mask build and the K3 launch) and ``placedb/add``
(the row and metadata writes); they nest inside a caller's ``frontend/``
or ``detector/`` range without taking its kernels from it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from omniswarm_torch.core.device import resolve_device
from omniswarm_torch.ops.frontend_kernels import retrieval_top1


class PlaceDB(NamedTuple):
    desc: torch.Tensor      # (N, D) unit global descriptors
    drone_id: torch.Tensor  # (N,) int64
    frame_id: torch.Tensor  # (N,) int64, per-drone keyframe sequence number
    valid: torch.Tensor     # (N,) bool
    cursor: int             # inserts so far; the next slot is cursor % N


def make_placedb(capacity: int, dim: int, device="cuda",
                 dtype=torch.float32) -> PlaceDB:
    """An empty database on ``device`` (the GPU unless the CPU is asked
    for)."""
    dev = resolve_device(device)
    return PlaceDB(
        desc=torch.zeros((capacity, dim), dtype=dtype, device=dev),
        drone_id=torch.full((capacity,), -1, dtype=torch.int64, device=dev),
        frame_id=torch.full((capacity,), -1, dtype=torch.int64, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        cursor=0)


def add(db: PlaceDB, desc: torch.Tensor, drone_id: int,
        frame_id: int) -> PlaceDB:
    """Insert one descriptor at the ring's next slot (in place)."""
    with record_function("placedb/add"):
        slot = db.cursor % db.desc.shape[0]
        db.desc[slot] = desc.to(db.desc.dtype)
        db.drone_id[slot] = int(drone_id)
        db.frame_id[slot] = int(frame_id)
        db.valid[slot] = True
    return db._replace(cursor=db.cursor + 1)


def _as_col(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64,
                           device=like.device).reshape(-1, 1)


def _usable(db: PlaceDB, query_drone, query_frame,
            match_index_dist) -> torch.Tensor:
    """(Q, N) bool: valid entries outside each query's recency guard."""
    qd, qf = _as_col(query_drone, db.drone_id), _as_col(query_frame,
                                                        db.frame_id)
    recent = (db.drone_id[None, :] == qd) & (
        torch.abs(db.frame_id[None, :] - qf)
        < _as_col(match_index_dist, db.frame_id))
    return db.valid[None, :] & ~recent


def _masked_sims(db: PlaceDB, desc: torch.Tensor, query_drone, query_frame,
                 match_index_dist) -> torch.Tensor:
    sims = desc.reshape(-1, db.desc.shape[1]) @ db.desc.T    # (Q, N)
    usable = _usable(db, query_drone, query_frame, match_index_dist)
    return torch.where(usable, sims, float("-inf"))


def _topk_stable(sims: torch.Tensor, k: int):
    top_sim, top_idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    return top_idx[..., :k], top_sim[..., :k]


def query(db: PlaceDB, desc: torch.Tensor, query_drone, query_frame, *,
          match_index_dist=10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best database hit for one query descriptor (D,), through K3.

    Returns (best_index, best_similarity) as 0-d tensors; (0, -inf) when
    every entry is invalid or guarded. The caller applies the local/remote
    similarity threshold.
    """
    mask = _usable(db, query_drone, query_frame, match_index_dist)
    best, sim = retrieval_top1(db.desc, desc.reshape(1, -1).contiguous(),
                               mask)
    return best[0], sim[0]


def query_batch(db: PlaceDB, desc: torch.Tensor, query_drone, query_frame,
                *, match_index_dist=10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched retrieval through one K3 launch: desc (B, D), query_drone and
    query_frame (B,) -> (best_idx (B,), best_sim (B,))."""
    with record_function("placedb/query"):
        mask = _usable(db, query_drone, query_frame, match_index_dist)
        return retrieval_top1(db.desc, desc.contiguous(), mask)


def query_topk(db: PlaceDB, desc: torch.Tensor, query_drone, query_frame, *,
               k: int = 5, match_index_dist=10):
    """Top-k database hits of one query (D,), best first; invalid and
    guarded entries carry -inf. Returns (top_idx (k,), top_sim (k,))."""
    sims = _masked_sims(db, desc, query_drone, query_frame,
                        match_index_dist)[0]
    return _topk_stable(sims, min(k, sims.shape[0]))


def query_topk2(db_a: PlaceDB, db_b: PlaceDB, desc: torch.Tensor, meta, *,
                k: int = 5):
    """Top-k of one query over two databases.

    meta: 4 ints [query_drone, query_frame, guard_a, guard_b]. Returns
    (idx_a, sim_a, idx_b, sim_b).
    """
    qd, qf, guard_a, guard_b = (int(v) for v in meta)
    k = min(k, db_a.desc.shape[0])
    ia, sa = _topk_stable(_masked_sims(db_a, desc, qd, qf, guard_a)[0], k)
    ib, sb = _topk_stable(_masked_sims(db_b, desc, qd, qf, guard_b)[0], k)
    return ia, sa, ib, sb


def _insert_slots(add_sel, sel_val: int, cursor: int, cap: int):
    """(rows, slots): the batch rows with ``add_sel == sel_val`` and the
    ring slots they take, in batch order from ``cursor`` (insert order is
    the cumulative count of selected rows). Where one batch inserts more
    rows than the ring holds, the last write to a slot wins."""
    rows = np.flatnonzero(np.asarray(add_sel) == sel_val)
    slots = (cursor + np.arange(len(rows))) % cap
    if len(rows) > cap:
        rows, slots = rows[-cap:], slots[-cap:]
    return rows, slots


def _insert(db: PlaceDB, descs: torch.Tensor, metas: torch.Tensor,
            add_sel, sel_val: int) -> PlaceDB:
    rows, slots = _insert_slots(add_sel, sel_val, db.cursor,
                                db.desc.shape[0])
    if len(rows):
        dev = db.desc.device
        r = torch.as_tensor(rows, device=dev)
        sl = torch.as_tensor(slots, device=dev)
        db.desc[sl] = descs[r].to(db.desc.dtype)
        db.drone_id[sl] = metas[r, 0].to(db.drone_id.dtype)
        db.frame_id[sl] = metas[r, 1].to(db.frame_id.dtype)
        db.valid[sl] = True
    return db._replace(
        cursor=db.cursor + int((np.asarray(add_sel) == sel_val).sum()))


def query2_add_batch(db_a: PlaceDB, db_b: PlaceDB, descs: torch.Tensor,
                     metas: torch.Tensor, add_sel, *, k: int = 5):
    """Q queries against both databases, then the masked ring inserts.

    descs: (Q, D) unit query descriptors; metas: (Q, 4) integer tensor
    [drone, frame, guard_a, guard_b]; add_sel: (Q,) host integers (numpy or
    a list): 0 query-only, 1 insert into db_a, 2 insert into db_b. Every
    query sees the databases as they were before the batch. Returns
    (idx_a, sim_a, idx_b, sim_b, db_a', db_b'); the two databases are
    written in place.
    """
    k = min(k, db_a.desc.shape[0])          # tiny-capacity DBs
    metas = torch.as_tensor(metas, device=db_a.desc.device)
    ia, sa = _topk_stable(_masked_sims(db_a, descs, metas[:, 0], metas[:, 1],
                                       metas[:, 2]), k)
    ib, sb = _topk_stable(_masked_sims(db_b, descs, metas[:, 0], metas[:, 1],
                                       metas[:, 3]), k)
    return (ia, sa, ib, sb, _insert(db_a, descs, metas, add_sel, 1),
            _insert(db_b, descs, metas, add_sel, 2))


def _scatter_payload(pay: torch.Tensor, qpacks: torch.Tensor, add_sel,
                     sel_val: int, cursor: int) -> torch.Tensor:
    rows, slots = _insert_slots(add_sel, sel_val, cursor, pay.shape[0])
    if len(rows):
        dev = pay.device
        pay[torch.as_tensor(slots, device=dev)] = qpacks[
            torch.as_tensor(rows, device=dev)].to(pay.dtype)
    return pay


def query2_add_payload_batch(db_a: PlaceDB, db_b: PlaceDB,
                             pay_a: torch.Tensor, pay_b: torch.Tensor,
                             descs: torch.Tensor, metas: torch.Tensor,
                             add_sel, qpacks: torch.Tensor, *, k: int = 5):
    """``query2_add_batch`` plus the landmark-payload rings.

    pay_a/pay_b: (N, Kb, P) f16 rings mirroring the descriptor rings' slots
    (each keyframe's packed local descriptors, validity, pixels and 3-D
    points); qpacks: (Q, Kb, P), written at the same insert slots, in place.
    Returns (idx_a, sim_a, idx_b, sim_b, db_a', db_b', pay_a', pay_b').
    """
    cur_a, cur_b = db_a.cursor, db_b.cursor
    ia, sa, ib, sb, na, nb = query2_add_batch(
        db_a, db_b, descs, metas, add_sel, k=k)
    return (ia, sa, ib, sb, na, nb,
            _scatter_payload(pay_a, qpacks, add_sel, 1, cur_a),
            _scatter_payload(pay_b, qpacks, add_sel, 2, cur_b))
