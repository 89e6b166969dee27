"""Mutual-nearest-neighbour matching of unit descriptors.

Counterpart of ``omniswarm_tpu/ops/matching.py`` (:17-40), batched over any
leading dimensions: one similarity product, then argmax both ways and the
mutual / threshold / validity masks. ``torch.argmax`` returns the first of
equal maxima, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Matches(NamedTuple):
    idx_b: torch.Tensor   # (..., K) best b-index per a-keypoint
    sim: torch.Tensor     # (..., K) cosine similarity of that match
    mask: torch.Tensor    # (..., K) bool: mutual, above threshold, both valid


def mutual_match(desc_a: torch.Tensor, desc_b: torch.Tensor,
                 valid_a: torch.Tensor, valid_b: torch.Tensor,
                 *, min_similarity: float = 0.0) -> Matches:
    """Mutual-NN matching of unit descriptors.

    desc_a: (..., K, C), desc_b: (..., M, C). min_similarity is the
    inner-product threshold (an L2 threshold d on unit vectors is
    ip > 1 - d^2/2).
    """
    sim = desc_a @ desc_b.transpose(-1, -2)                  # (..., K, M)
    both = valid_a[..., :, None] & valid_b[..., None, :]
    sim = torch.where(both, sim, float("-inf"))
    best_b = torch.argmax(sim, dim=-1)                       # (..., K)
    best_a = torch.argmax(sim, dim=-2)                       # (..., M)
    best_sim = torch.gather(sim, -1, best_b[..., None])[..., 0]
    k_idx = torch.arange(desc_a.shape[-2], device=desc_a.device)
    mutual = torch.gather(best_a, -1, best_b) == k_idx
    mask = mutual & (best_sim > min_similarity) & valid_a
    return Matches(best_b, best_sim, mask)
