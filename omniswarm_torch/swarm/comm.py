"""Keyframe container of the port.

A copy of ``KeyframeData`` from ``omniswarm_tpu/swarm/comm.py`` (:42); the
bus, packets and transports come with the back-end slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class KeyframeData:
    """A keyframe's shareable content (ImageDescriptor_t equivalent)."""

    drone_id: int
    frame_id: int
    t: float
    pose: np.ndarray               # (4,) VIO pose at keyframe
    global_desc: np.ndarray        # (G,) unit NetVLAD descriptor
    kp_xy: np.ndarray              # (K, 2) pixel coords
    landmarks_3d: np.ndarray       # (K, 3) body-frame 3-D points
    local_desc: np.ndarray         # (K, C) unit local descriptors
    valid: np.ndarray              # (K,) bool
    image: Optional[np.ndarray] = None  # (H, W) grayscale in [0,1], optional
    # match-only frame: receiver must not add it to its database
    # (prevent_adding_db, swarm_loop.cpp:155-158, loop_detector.cpp:89-94)
    prevent_adding_db: bool = False
