"""Strong augmentation, the COCO json readers, the two-stream train loader
and the test loader (PyTorch port of ubteacher_tpu.data)."""
