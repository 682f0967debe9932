"""The port imports torch and never jax, flax, optax or ubteacher_tpu."""

import subprocess
import sys

MODULES = [
    "ubteacher_tpu_torch",
    "ubteacher_tpu_torch.checkpoint",
    "ubteacher_tpu_torch.config",
    "ubteacher_tpu_torch.data.augment",
    "ubteacher_tpu_torch.engine",
    "ubteacher_tpu_torch.modeling.fcos_head",
    "ubteacher_tpu_torch.ops.kernels",
    "ubteacher_tpu_torch.ops.nms",
    "ubteacher_tpu_torch.solver",
    "ubteacher_tpu_torch.structures",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ubteacher_tpu', 'triton'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
