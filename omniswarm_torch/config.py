"""Front-end configuration of the port.

The fields of ``FrontendParams`` in ``omniswarm_tpu/config.py`` (:116-195)
that the keyframe path reads, with the reference's defaults, so that the
port needs no JAX package at run time. The detector's fields (RANSAC, PnP,
loop acceptance, batched verification) come with the code that reads them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FrontendParams:
    """Visual front-end parameters (swarm_loop's globals).

    Defaults from loop_defines.h / swarm_loop.cpp:214-270 /
    nodelet-sfisheye.launch.
    """

    width: int = 400
    height: int = 208
    max_keypoints: int = 200            # superpoint max_num
    superpoint_thres: float = 0.012
    nms_dist: int = 4                   # NMS2 grid suppression radius
    local_desc_dim: int = 64            # FEATURE_DESC_SIZE (PCA of 256)
    global_desc_dim: int = 4096         # DEEP_DESC_SIZE (NetVLAD)
    netvlad_thres: float = 0.3          # inner-product loop candidate thres
    match_index_dist: int = 10          # recency guard MATCH_INDEX_DIST
    triangulate_max_err: float = 0.05
    max_db_size: int = 4096             # place-recognition database capacity
