"""Core helpers of the port: matmul precision, pose geometry, devices."""
