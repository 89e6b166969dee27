"""SuperPoint and MobileNetVLAD as ``torch.nn`` modules (NCHW)."""
