"""The port imports torch and never jax, flax, optax or ubteacher_tpu; nor
cv2, which only the test loader's default image reader imports, at its call."""

import subprocess
import sys

MODULES = [
    "ubteacher_tpu_torch",
    "ubteacher_tpu_torch.checkpoint",
    "ubteacher_tpu_torch.config",
    "ubteacher_tpu_torch.data.augment",
    "ubteacher_tpu_torch.data.coco",
    "ubteacher_tpu_torch.data.loader",
    "ubteacher_tpu_torch.engine",
    "ubteacher_tpu_torch.engine.rcnn_trainer",
    "ubteacher_tpu_torch.evaluation",
    "ubteacher_tpu_torch.evaluation.coco_eval",
    "ubteacher_tpu_torch.evaluation.evaluator",
    "ubteacher_tpu_torch.evaluation.native",
    "ubteacher_tpu_torch.evaluation.proposal_eval",
    "ubteacher_tpu_torch.modeling.anchors",
    "ubteacher_tpu_torch.modeling.box_regression",
    "ubteacher_tpu_torch.modeling.fast_rcnn",
    "ubteacher_tpu_torch.modeling.fcos_head",
    "ubteacher_tpu_torch.modeling.matcher",
    "ubteacher_tpu_torch.modeling.rcnn",
    "ubteacher_tpu_torch.modeling.rpn",
    "ubteacher_tpu_torch.ops.kernels",
    "ubteacher_tpu_torch.ops.kernels.build",
    "ubteacher_tpu_torch.ops.kernels.stem_cuda",
    "ubteacher_tpu_torch.ops.nms",
    "ubteacher_tpu_torch.ops.roi_align",
    "ubteacher_tpu_torch.ops.row_gather",
    "ubteacher_tpu_torch.ops.stem",
    "ubteacher_tpu_torch.solver",
    "ubteacher_tpu_torch.structures",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ubteacher_tpu', 'triton', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
