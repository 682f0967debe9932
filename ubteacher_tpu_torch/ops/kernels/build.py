"""Build the CUDA sources of `ubteacher_tpu_torch/csrc/` with nvcc.

Each source `csrc/<name>.cu` has a plain C interface and becomes its own
shared library `_build/libubt_<name>.so` for sm_90a, loaded with ctypes by
its wrapper module. A library is built on first use, from the sources in this
package only, and rebuilt when its source is newer. `build_all` starts one
nvcc per stale source at once, so a fresh checkout builds every kernel in
the time of the slowest.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import Dict, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")

SOURCES = ("nms", "matcher", "roi_align", "row_scatter")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def source_path(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"libubt_{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(source_path(name))


def _command(name: str, out: str) -> list:
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", out, source_path(name),
    ]


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Tuple[str, str, float]]:
    """Compile every stale source among `names` concurrently. Returns
    {name: (library path, nvcc's register/shared-memory report, seconds)};
    the report is empty and the time 0 for a library that was up to date.
    Raises with the compiler's output if any build fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out: Dict[str, Tuple[str, str, float]] = {}
    running = {}
    for name in names:
        if not _stale(name):
            out[name] = (library_path(name), "", 0.0)
            continue
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, cmd, tmp, time.perf_counter())
    failures = []
    for name, (proc, cmd, tmp, t0) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, library_path(name))
        out[name] = (library_path(name), stderr, time.perf_counter() - t0)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def build(name: str) -> str:
    """Path of the library for csrc/<name>.cu, compiled first if needed."""
    return build_all((name,))[name][0]
