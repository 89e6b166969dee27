"""Simulator of the port (numpy) and the factor graph built from it."""
from omniswarm_torch.sim.simulator import (  # noqa: F401
    DetMeas,
    LoopMeas,
    SimData,
    SimParams,
    generate,
)
from omniswarm_torch.sim.pipeline import build_graph_from_sim  # noqa: F401
