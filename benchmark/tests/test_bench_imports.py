"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the port: by whole top-level module names
(`ubteacher_tpu_torch` begins with `ubteacher_tpu` and is not it)."""

import ast
import json
import os
import subprocess
import sys

from benchmark.harness import manifest
from benchmark.run import forbidden_modules

JAX_SIDE = {"jax", "jaxlib", "flax", "ubteacher_tpu"}


def imported_top_names(root):
    names = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                for node in ast.walk(ast.parse(open(path).read())):
                    if isinstance(node, ast.Import):
                        found = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and node.level == 0:
                        found = [node.module]
                    else:
                        continue
                    for n in found:
                        names.setdefault(n.split(".")[0], set()).add(path)
    return names


def test_no_source_of_the_benchmark_imports_the_jax_side():
    names = imported_top_names(manifest.BENCH_DIR)
    assert not JAX_SIDE & set(names), {n: names[n] for n in JAX_SIDE & set(names)}
    assert "ubteacher_tpu_torch" in names  # the train cell does import the port


def test_no_source_of_the_reference_imports_the_port():
    names = imported_top_names(os.path.join(manifest.BENCH_DIR, "reference"))
    assert not (JAX_SIDE | {"ubteacher_tpu_torch", "benchmark"}) & set(names)


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True, cwd=manifest.ROOT,
                         env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_chip_path_loads_neither_jax_nor_the_jax_package():
    loaded = _loaded_after(
        "import benchmark.run as r; r.keep_tensorflow_out()\n"
        "import benchmark.harness.train_cell, benchmark.harness.refrun, benchmark.harness.flops, benchmark.harness.control\n"
        "import ubteacher_tpu_torch.engine.trainer\n"
        "from torch.utils.tensorboard import SummaryWriter\n"
        "from benchmark.harness import manifest\n"
        "[manifest.reader(m['name']) for m in manifest.manifest()['per_layer'] + manifest.manifest()['end_to_end']]")
    assert "ubteacher_tpu_torch" in loaded
    assert not JAX_SIDE & loaded, JAX_SIDE & loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(
        "import benchmark.reference.ubtref.engine.fcos_trainer, benchmark.reference.ubtref.data.loader")
    assert not (JAX_SIDE | {"ubteacher_tpu_torch"}) & loaded


def test_the_run_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ubteacher_tpu_torch_like", sys)
    assert "ubteacher_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "ubteacher_tpu.engine", sys)
    assert "ubteacher_tpu" in forbidden_modules()
