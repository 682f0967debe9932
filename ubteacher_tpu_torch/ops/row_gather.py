"""Batched row gather whose backward is the row-scatter kernel (PyTorch port
of ubteacher_tpu.ops.pallas.row_gather_pallas.take_rows).

take_rows(x (B, L, D), rows (B, K)) == torch.gather(x, 1, rows[..., None]
expanded to D): the forward is torch.gather, as the JAX forward is XLA's
gather outside Pallas; the backward scatters the K gradient rows into a
(B, L, D) grid with ops/kernels/row_scatter_cuda.py (the kernel on CUDA
tensors, its index_put_ version on CPU tensors), duplicates accumulating.
"""

from __future__ import annotations

import torch

from .kernels.row_scatter_cuda import scatter_rows


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.save_for_backward(rows)
        ctx.length = x.shape[1]
        return torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[2]))

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return scatter_rows(g.float().contiguous(), rows, ctx.length).to(g.dtype), None


def take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (B, L, D), rows (B, K) int64 -> (B, K, D); the gradient flows to x
    only."""
    return _TakeRows.apply(x, rows.long().contiguous())
