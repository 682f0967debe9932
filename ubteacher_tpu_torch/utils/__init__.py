"""Metric storage, the logger and training visualization (PyTorch port of
ubteacher_tpu.utils)."""
