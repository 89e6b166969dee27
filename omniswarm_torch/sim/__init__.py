"""Simulator of the port (numpy only; imports no pipeline module)."""
from omniswarm_torch.sim.simulator import (  # noqa: F401
    DetMeas,
    LoopMeas,
    SimData,
    SimParams,
    generate,
)
