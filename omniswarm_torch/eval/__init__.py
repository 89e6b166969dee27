"""Evaluation metrics of the port (numpy)."""
