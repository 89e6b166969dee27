"""Factor-graph structure dump as Graphviz .dot.

A copy of ``omniswarm_tpu/utils/cgraph.py``; it takes the port's
``solver.graph.FactorGraph`` or ``solver.dense.DenseGraph`` (tensors or
arrays).

Equivalent of the reference's generate_cgraph (swarm_localization_solver.cpp
:1805-1976, gated by enable_cgraph_generation): writes the current
sliding-window problem — pose nodes per (frame, drone) and VIO / distance /
detection / loop edges — as a .dot file for debugging, without needing
libcgraph (plain text emission).
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A graph leaf on the host (a tensor on any device, or an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _node(f: int, d: int) -> str:
    return f"p_f{f}_d{d}"


def graph_to_dot(graph, path: str | None = None) -> str:
    """Serialize a FactorGraph or DenseGraph to Graphviz dot text."""
    lines = ["graph swarm {", "  rankdir=LR;"]
    pv = _np(graph.pose_valid)
    pf = _np(graph.pose_fixed)
    F, D = pv.shape
    for f in range(F):
        for d in range(D):
            if pv[f, d]:
                style = ' style=filled fillcolor=gray' if pf[f, d] else ""
                lines.append(
                    f'  {_node(f, d)} [label="d{d}@f{f}"{style}];')

    def edge(na, nb, label, color):
        lines.append(f'  {na} -- {nb} [label="{label}" color={color}];')

    if hasattr(graph, "ranges"):            # generic FactorGraph
        r = graph.ranges
        for i in np.flatnonzero(_np(r.valid)):
            edge(_node(int(r.frame[i]), int(r.drone_a[i])),
                 _node(int(r.frame[i]), int(r.drone_b[i])),
                 f"dis {float(r.dist[i]):.2f}", "blue")
        o = graph.odoms
        for i in np.flatnonzero(_np(o.valid)):
            edge(_node(int(o.frame_a[i]), int(o.drone_a[i])),
                 _node(int(o.frame_b[i]), int(o.drone_b[i])),
                 "vio", "black")
        dt = graph.dets
        for i in np.flatnonzero(_np(dt.valid)):
            edge(_node(int(dt.frame_a[i]), int(dt.drone_a[i])),
                 _node(int(dt.frame_b[i]), int(dt.drone_b[i])),
                 "det", "orange")
    else:                                    # DenseGraph
        rv = _np(graph.range_valid)
        rd = _np(graph.range_dist)
        for f, a, b in zip(*np.nonzero(rv)):
            edge(_node(f, a), _node(f, b), f"dis {rd[f, a, b]:.2f}", "blue")
        ov = _np(graph.odom_valid)
        for f, d in zip(*np.nonzero(ov)):
            edge(_node(f, d), _node(f + 1, d), "vio", "black")
        dv = _np(graph.det_valid)
        for f, a, b in zip(*np.nonzero(dv)):
            edge(_node(f, a), _node(f, b), "det", "orange")

    l = graph.loops
    for i in np.flatnonzero(_np(l.valid)):
        edge(_node(int(l.frame_a[i]), int(l.drone_a[i])),
             _node(int(l.frame_b[i]), int(l.drone_b[i])),
             "loop", "red")

    lines.append("}")
    text = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
