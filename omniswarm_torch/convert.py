"""Carry problem data across from the JAX package's containers.

The solve has no learned parameters: its "weights" are the factor graph and,
for a warm restart, the Newton-Schulz warm state. ``dense_graph_to_torch``
reads any DenseGraph-shaped object field by field (numpy, JAX or torch
leaves; JAX leaves go through ``numpy.asarray``) and builds the port's
``DenseGraph`` on a device. The JAX package is never imported: the
conversion works on duck-typed fields.
"""
from __future__ import annotations

import numpy as np
import torch

from omniswarm_torch.solver.dense import DenseGraph
from omniswarm_torch.solver.graph import RelPoseFactors


def _tensor(x, device: torch.device):
    if x is None:
        return None
    # torch.tensor copies: JAX hands out read-only numpy views
    t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
    if t.is_floating_point():
        t = t.to(torch.float32)
    elif t.dtype != torch.bool:
        t = t.to(torch.int64)           # indices
    return t.to(device)


def dense_graph_to_torch(graph, device) -> DenseGraph:
    """The port's DenseGraph, on ``device``, from a DenseGraph-shaped object."""
    dev = torch.device(device)
    fields = {}
    for name in DenseGraph._fields:
        value = getattr(graph, name, None)
        if name == "loops":
            fields[name] = RelPoseFactors(
                *(_tensor(getattr(value, f), dev)
                  for f in RelPoseFactors._fields))
        else:
            fields[name] = _tensor(value, dev)
    return DenseGraph(**fields)


def warm_state_to_torch(warm, device):
    """Map a (nested tuple) warm state of arrays to f32 tensors on device."""
    if isinstance(warm, (tuple, list)):
        return tuple(warm_state_to_torch(w, device) for w in warm)
    return _tensor(warm, torch.device(device))
