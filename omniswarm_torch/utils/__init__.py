"""Utilities of the port: telemetry."""
from omniswarm_torch.utils.telemetry import GLOBAL, Telemetry  # noqa: F401
