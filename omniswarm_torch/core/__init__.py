"""Core helpers of the port: matmul precision, pose geometry, devices."""
from omniswarm_torch.core import geometry, trajectory  # noqa: F401
