"""Hand-written Hopper kernels of the FCOS and Faster R-CNN train steps and of
the fused stem on the evaluation path.

Each kernel module holds a wrapper, the plain PyTorch version of the same
function, and a plain-integer launch counter in `LAUNCHES`. A wrapper uses the
plain version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. Triton is imported, and CUDA sources are compiled, only
inside the functions that launch the kernels.
"""

from __future__ import annotations

from typing import Dict

from . import focal_triton, giou_cuda, matcher_cuda, nms_cuda, roi_align_cuda, row_scatter_cuda, stem_cuda

_MODULES = (focal_triton, giou_cuda, nms_cuda, matcher_cuda, roi_align_cuda, row_scatter_cuda, stem_cuda)


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches since the last reset}."""
    out: Dict[str, int] = {}
    for mod in _MODULES:
        out.update(mod.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    for mod in _MODULES:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Adds {kernel name: launches} to the counters: what a CUDA graph's
    replay launches, which no wrapper counts (engine/step_graph.py)."""
    for mod in _MODULES:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] += counts.get(name, 0)
