"""State capture of the port: estimator checkpoints and recordings."""
