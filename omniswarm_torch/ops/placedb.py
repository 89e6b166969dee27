"""Place-recognition database: a fixed-capacity descriptor matrix.

Counterpart of ``omniswarm_tpu/ops/placedb.py`` (:19-111 and :193-204).
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
device read.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

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
