"""The R-CNN cell's harness modules and the reference's R-CNN modules load
with JAX and the JAX package blocked (an import of either raises), and the
reference's load nothing of the port."""

import json
import os
import subprocess
import sys

from benchmark.harness import manifest

BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "ubteacher_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""
REFERENCE = ("benchmark.reference.ubtref.engine.rcnn_trainer", "benchmark.reference.ubtref.engine.replay",
             "benchmark.reference.ubtref.modeling.rcnn", "benchmark.reference.ubtref.ops.roi_align",
             "benchmark.reference.ubtref.ops.row_gather")
HARNESS = ("benchmark.harness.rcnn_train_cell", "benchmark.harness.rcnn_bounds", "benchmark.harness.rcnn_refrun",
           "benchmark.harness.rcnn_flops")


def _loaded_after(modules):
    code = BLOCK + "".join(f"import {m}\n" for m in modules) + (
        "import json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=manifest.ROOT, env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_rcnn_harness_loads_with_the_jax_side_blocked():
    loaded = _loaded_after(HARNESS + REFERENCE)
    assert not {"jax", "jaxlib", "flax", "ubteacher_tpu"} & loaded


def test_the_reference_rcnn_loads_nothing_of_the_port():
    loaded = _loaded_after(REFERENCE)
    assert "ubteacher_tpu_torch" not in loaded and "torch" in loaded
