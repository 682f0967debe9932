"""Box geometry, losses and NMS (PyTorch port of ubteacher_tpu.ops)."""
