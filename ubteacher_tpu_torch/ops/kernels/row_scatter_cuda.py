"""Row scatter-add, the backward of the RPN's row gather: the CUDA kernel
(`csrc/row_scatter.cu`) and its plain PyTorch version.

Replaces ubteacher_tpu/ops/pallas/row_gather_pallas.py:scatter_rows_pallas
(_scatter_rows_kernel), reached from the take_rows VJP. On the H100 it is
bound by writing its output once: a (B, L, D) float32 grid that is almost all
zeros (99 MB at the RPN's (24, 85,932, 12)) against a few hundred gradient
rows. So the kernel is one launch into a `torch.empty` output: each block
owns a run of one image's grid as a shared-memory tile, adds the rows that
land in it in k order and stores the run once, zeros included, with 16-byte
streaming stores. The fixed order makes the sum of duplicate rows the same
from run to run. The head of csrc/row_scatter.cu sets the design out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LAUNCHES = {"row_scatter": 0}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build.build("row_scatter"))
    fn = lib.ubt_scatter_rows
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    return lib


def scatter_rows_kernel(g: torch.Tensor, rows: torch.Tensor, length: int) -> torch.Tensor:
    """Launch the CUDA kernel. g (B, K, D) f32 and rows (B, K) int64 on one
    CUDA device, contiguous. Returns (B, length, D) f32 with g[b, k] added
    at row rows[b, k], every element written by the kernel; duplicates
    accumulate in k order, rows outside [0, length) are dropped."""
    if not g.is_cuda or rows.device != g.device:
        raise ValueError("scatter_rows_kernel: tensors must be on one CUDA device")
    if g.dtype != torch.float32 or rows.dtype != torch.int64:
        raise TypeError(f"scatter_rows_kernel: expected float32 and int64, got {g.dtype}, {rows.dtype}")
    if g.dim() != 3 or rows.shape != g.shape[:2]:
        raise ValueError(
            f"scatter_rows_kernel: expected (B, K, D) and (B, K), got {tuple(g.shape)}, {tuple(rows.shape)}"
        )
    if not (g.is_contiguous() and rows.is_contiguous()):
        raise ValueError("scatter_rows_kernel: tensors must be contiguous")
    b, k, d = g.shape
    if max(b, k, length, d) >= 2**31:
        raise ValueError(f"scatter_rows_kernel: B={b}, K={k}, L={length}, D={d} exceed the launch limits")
    out = torch.empty((b, length, d), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.ubt_scatter_rows(g.data_ptr(), rows.data_ptr(), b, k, length, d, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row scatter kernel launch failed: CUDA error {err}")
    LAUNCHES["row_scatter"] += 1
    return out


def scatter_rows_plain(g: torch.Tensor, rows: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version: index_put_ with accumulate into a zero (B, L, D) grid."""
    b, k, d = g.shape
    out = torch.zeros((b, length, d), dtype=g.dtype, device=g.device)
    batch = torch.arange(b, device=g.device)[:, None].expand(b, k)
    return out.index_put_((batch, rows), g, accumulate=True)


def scatter_rows(g: torch.Tensor, rows: torch.Tensor, length: int) -> torch.Tensor:
    """(B, length, D) scatter-add of g's rows. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if g.device.type == "cpu":
        return scatter_rows_plain(g, rows, length)
    return scatter_rows_kernel(g, rows, length)
