"""Evaluation metrics of the port (automoe_tpu/evals)."""
