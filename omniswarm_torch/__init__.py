"""PyTorch/CUDA port of omniswarm_tpu.

The JAX package ``omniswarm_tpu`` stays the reference; this package mirrors
its module names (``sim``, ``eval``, ``core``, ``solver``) and never imports
it. Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
