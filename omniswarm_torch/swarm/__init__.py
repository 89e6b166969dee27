"""Swarm layer of the port: the estimator, the fast window build, the
keyframe container and the front-end cameras."""
from omniswarm_torch.swarm.estimator import (  # noqa: F401
    DetRecord,
    KeyframeRecord,
    LoopRecord,
    SwarmEstimator,
)
