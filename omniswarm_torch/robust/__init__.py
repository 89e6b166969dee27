"""Robust estimation of the port: PCM loop outlier rejection and the
data-association initializer."""
from omniswarm_torch.robust.pcm import (  # noqa: F401
    LoopSet,
    PCMResult,
    consistency_matrix,
    loopset_from_measurements,
    pcm_filter,
)
