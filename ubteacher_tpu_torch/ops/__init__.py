"""Box geometry, losses and NMS (PyTorch port of ubteacher_tpu.ops).

Importing this package registers the torch.library ops of the kernels on the
inference path (`ubt::nms_sorted_keep`, `ubt::roi_align_forward`,
`ubt::stem_conv_pool`): a process that loads an exported inference program
(tools/export_inference.py) needs this import and torch, nothing else.
"""

from . import kernels, stem  # noqa: F401 (registers the ops)
