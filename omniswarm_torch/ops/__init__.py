"""Front-end ops of the port: keypoints, matching, triangulation, place
retrieval, and the dispatchers of the hand-written kernels K2 and K3."""
from omniswarm_torch.ops import (  # noqa: F401
    camera,
    keypoints,
    matching,
    placedb,
    ransac,
    triangulation,
)
