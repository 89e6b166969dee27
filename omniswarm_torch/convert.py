"""Carry problem data and weights across from the JAX package's containers.

The solve has no learned parameters: its "weights" are the factor graph and,
for a warm restart, the Newton-Schulz warm state. ``dense_graph_to_torch``
and ``factor_graph_to_torch`` read any DenseGraph- or FactorGraph-shaped
object field by field (numpy, JAX or torch leaves; JAX leaves go through
``numpy.asarray``) and build the port's container on a device. A stacked
DenseGraph (a leading lane axis on every leaf) converts the same way. The
JAX package is never imported: the conversion works on duck-typed fields.

The front-end's networks do have weights. ``superpoint_params_from_flax``
and ``netvlad_params_from_flax`` take a flat Flax-layout dict of numpy
arrays (``/``-joined paths, as the reference's ``.npz`` checkpoints store
them) and return the ``state_dict`` of the port's extractor:

- conv kernels HWIO -> OIHW; a depthwise kernel (3, 3, 1, C) becomes
  (C, 1, 3, 3) for ``groups=C`` by the same transpose;
- Dense kernels (in, out) -> Linear weights (out, in);
- GroupNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- every array to f32 (the checkpoints are f16), as the reference's
  ``jnp.asarray(raw[k], jnp.float32)`` does.

``superpoint_params_to_flax`` and ``netvlad_params_to_flax`` are their
inverses: a port state dict to the flat Flax layout (OIHW -> HWIO, a 2-D
``weight`` -> a Dense ``kernel`` (in, out), a 1-D ``weight`` -> a
GroupNorm ``scale``), as f32 numpy arrays, for the checkpoint writers.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from omniswarm_torch.solver.dense import DenseGraph
from omniswarm_torch.solver.graph import (DetectionFactors, FactorGraph,
                                          RangeFactors, RelPoseFactors)


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


def _container(cls, obj, device: torch.device, nested=None):
    """``cls`` built field by field from ``obj``; ``nested`` maps a field
    name to the container class of that field."""
    nested = nested or {}
    fields = {}
    for name in cls._fields:
        value = getattr(obj, name, None)
        fields[name] = (_container(nested[name], value, device)
                        if name in nested else _tensor(value, device))
    return cls(**fields)


def dense_graph_to_torch(graph, device) -> DenseGraph:
    """The port's DenseGraph, on ``device``, from a DenseGraph-shaped object
    (single or stacked)."""
    return _container(DenseGraph, graph, torch.device(device),
                      {"loops": RelPoseFactors})


def factor_graph_to_torch(graph, device) -> FactorGraph:
    """The port's FactorGraph, on ``device``, from a FactorGraph-shaped
    object."""
    return _container(FactorGraph, graph, torch.device(device),
                      {"ranges": RangeFactors, "odoms": RelPoseFactors,
                       "loops": RelPoseFactors, "dets": DetectionFactors})


def warm_state_to_torch(warm, device):
    """Map a (nested tuple) warm state of arrays to f32 tensors on device."""
    if isinstance(warm, (tuple, list)):
        return tuple(warm_state_to_torch(w, device) for w in warm)
    return _tensor(warm, torch.device(device))


def _flax_leaf(path: str, value: np.ndarray):
    """(torch key, tensor) of one Flax leaf at ``params/a/b/leaf``."""
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    *mods, leaf = parts
    v = np.array(value, np.float32)         # a copy: JAX leaves are read-only
    if leaf == "kernel":
        leaf = "weight"
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mods + [leaf]), torch.from_numpy(np.ascontiguousarray(v))


def _torch_leaf(key: str, value: torch.Tensor):
    """(flat Flax path, f32 numpy array) of one port state-dict entry."""
    *mods, leaf = key.split(".")
    v = value.detach().to("cpu", torch.float32).numpy()
    if leaf == "weight":
        if v.ndim == 4:
            leaf, v = "kernel", v.transpose(2, 3, 1, 0)
        elif v.ndim == 2:
            leaf, v = "kernel", v.T
        else:
            leaf = "scale"
    return "/".join(["params", *mods, leaf]), np.ascontiguousarray(v)


def superpoint_params_from_flax(flat: Mapping[str, np.ndarray]
                                ) -> Dict[str, torch.Tensor]:
    """``SuperPointExtractor`` state_dict from flat Flax SuperPoint params
    (``params/conv1a/kernel`` ...) plus ``pca_components`` and
    ``pca_mean``."""
    out = {}
    for path, value in flat.items():
        if path in ("pca_components", "pca_mean"):
            out[path] = torch.from_numpy(np.array(value, np.float32))
        else:
            key, t = _flax_leaf(path, value)
            out[f"net.{key}"] = t
    return out


def netvlad_params_from_flax(flat: Mapping[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """``GlobalDescriptorExtractor`` state_dict from flat Flax MobileNetVLAD
    params (``params/encoder/stem/kernel`` ...)."""
    return dict(("model." + k, t) for k, t in
                (_flax_leaf(p, v) for p, v in flat.items()))


def superpoint_params_to_flax(params: Mapping[str, torch.Tensor]
                              ) -> Dict[str, np.ndarray]:
    """Flat Flax SuperPoint params (``params/conv1a/kernel`` ...) plus
    ``pca_components`` / ``pca_mean`` when present, from a ``SuperPoint``
    or ``SuperPointExtractor`` state_dict."""
    out = {}
    for key, value in params.items():
        if key in ("pca_components", "pca_mean"):
            out[key] = value.detach().to("cpu", torch.float32).numpy()
        else:
            path, v = _torch_leaf(key[4:] if key.startswith("net.") else key,
                                  value)
            out[path] = v
    return out


def netvlad_params_to_flax(params: Mapping[str, torch.Tensor]
                           ) -> Dict[str, np.ndarray]:
    """Flat Flax MobileNetVLAD params (``params/encoder/stem/kernel`` ...)
    from a ``MobileNetVLAD`` or ``GlobalDescriptorExtractor`` state_dict."""
    return dict(_torch_leaf(k[6:] if k.startswith("model.") else k, v)
                for k, v in params.items())
