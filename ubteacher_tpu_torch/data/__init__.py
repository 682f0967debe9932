"""Strong augmentation (PyTorch port of ubteacher_tpu.data, device part only)."""
