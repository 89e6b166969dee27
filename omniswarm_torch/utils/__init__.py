"""Utilities of the port: telemetry, the factor-graph dot dump and crash
diagnostics."""
from omniswarm_torch.utils.telemetry import GLOBAL, Telemetry  # noqa: F401
from omniswarm_torch.utils.cgraph import graph_to_dot  # noqa: F401
