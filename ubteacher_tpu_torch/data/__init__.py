"""Strong augmentation, the COCO json readers and the test loader (PyTorch
port of ubteacher_tpu.data; the two-stream train loader is not ported yet)."""
