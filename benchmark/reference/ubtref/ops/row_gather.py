"""Batched row gather, plain PyTorch: take_rows(x (B, L, D), rows (B, K))
is torch.gather along the rows, whose autograd backward is the scatter-add
of the K gradient rows into a (B, L, D) grid, duplicates accumulating (what
the port's row-scatter kernel computes)."""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (B, L, D), rows (B, K) int64 -> (B, K, D); the gradient flows to x
    only."""
    return torch.gather(x, 1, rows.long()[..., None].expand(-1, -1, x.shape[2]))
