"""The port imports torch and never jax, flax, optax, ubteacher_tpu or the
repo's tools/ (the JAX package's tools); nor cv2, which only the loaders'
default image reader and the training visualization import, at their
call."""

import subprocess
import sys

MODULES = [
    "ubteacher_tpu_torch",
    "ubteacher_tpu_torch.checkpoint",
    "ubteacher_tpu_torch.checkpoint.checkpointer",
    "ubteacher_tpu_torch.checkpoint.torch_weights",
    "ubteacher_tpu_torch.config",
    "ubteacher_tpu_torch.data.augment",
    "ubteacher_tpu_torch.data.coco",
    "ubteacher_tpu_torch.data.loader",
    "ubteacher_tpu_torch.engine",
    "ubteacher_tpu_torch.engine.rcnn_trainer",
    "ubteacher_tpu_torch.engine.trainer",
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
    "ubteacher_tpu_torch.ops",
    "ubteacher_tpu_torch.ops.kernels",
    "ubteacher_tpu_torch.ops.kernels.build",
    "ubteacher_tpu_torch.ops.kernels.stem_cuda",
    "ubteacher_tpu_torch.ops.nms",
    "ubteacher_tpu_torch.ops.roi_align",
    "ubteacher_tpu_torch.ops.row_gather",
    "ubteacher_tpu_torch.ops.stem",
    "ubteacher_tpu_torch.parallel",
    "ubteacher_tpu_torch.parallel.dist",
    "ubteacher_tpu_torch.solver",
    "ubteacher_tpu_torch.structures",
    "ubteacher_tpu_torch.tools",
    "ubteacher_tpu_torch.tools.ab_stem",
    "ubteacher_tpu_torch.tools.bench_loader",
    "ubteacher_tpu_torch.tools.common",
    "ubteacher_tpu_torch.tools.export_inference",
    "ubteacher_tpu_torch.tools.learning_sanity",
    "ubteacher_tpu_torch.tools.mfu",
    "ubteacher_tpu_torch.tools.microbench_rcnn",
    "ubteacher_tpu_torch.tools.parity_eval",
    "ubteacher_tpu_torch.tools.profile_step",
    "ubteacher_tpu_torch.tools.recipe_mix",
    "ubteacher_tpu_torch.tools.soak",
    "ubteacher_tpu_torch.train_net",
    "ubteacher_tpu_torch.utils.events",
    "ubteacher_tpu_torch.utils.visualizer",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ubteacher_tpu', 'tools', 'triton', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
