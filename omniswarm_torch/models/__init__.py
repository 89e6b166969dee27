"""SuperPoint and MobileNetVLAD as ``torch.nn`` modules (NCHW)."""
from omniswarm_torch.models.superpoint import (  # noqa: F401
    SuperPoint,
    SuperPointExtractor,
)
from omniswarm_torch.models.netvlad import (  # noqa: F401
    GlobalDescriptorExtractor,
    MobileNetVLAD,
    NetVLAD,
)
