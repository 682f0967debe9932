"""GIoU loss on aligned ltrb distances as a Triton forward kernel.

Replaces ubteacher_tpu/ops/pallas/giou_pallas.py:giou_loss_pallas
(_fwd_kernel), keeping its (I+1)/(U+1) smoothing and the `ac == 0` guard.

What bounds it on the H100: bytes moved. Each row reads 36 bytes (two ltrb
quadruples and a weight) and writes 4, against about thirty flops; eager
PyTorch runs the formula as some twenty separate elementwise passes over
(N, 4) and (N,) tensors.

What the design does about it: one pass over the rows in blocks of 512, each
thread loading its row's eight coordinates and weight and keeping every
intermediate in registers; the per-row weighted losses are written once and
summed by torch. As in the JAX package the backward is not a kernel: it is
autograd over the plain formula (giou_pallas.py:85-93), with no gradient to
the targets or the weight.

The kernel source lives in `_giou_jit.py`, imported on first launch only.
"""

from __future__ import annotations

import torch

from .. import losses

LAUNCHES = {"giou_fwd": 0}

_BLOCK = 512


def giou_rows_kernel(
    pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """Launch the forward kernel: (N, 4), (N, 4), (N,) -> per-row weighted
    loss (N,)."""
    for t in (pred, target, weight):
        if not t.is_cuda or t.device != pred.device:
            raise ValueError("giou_rows_kernel: all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"giou_rows_kernel: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("giou_rows_kernel: tensors must be contiguous")
    n = pred.shape[0]
    if pred.shape != (n, 4) or target.shape != (n, 4) or weight.shape != (n,):
        raise ValueError(
            f"giou_rows_kernel: expected (N, 4), (N, 4), (N,), got "
            f"{tuple(pred.shape)}, {tuple(target.shape)}, {tuple(weight.shape)}"
        )
    if 4 * n >= 2**31:
        raise ValueError(f"giou_rows_kernel: {n} rows exceed int32 offsets")
    from . import _giou_jit

    out = torch.empty((n,), dtype=torch.float32, device=pred.device)
    if n:
        grid = ((n + _BLOCK - 1) // _BLOCK,)
        with torch.cuda.device(pred.device):
            _giou_jit.giou_fwd_kernel[grid](
                pred, target, weight, out, n, BLOCK=_BLOCK, num_warps=4
            )
        LAUNCHES["giou_fwd"] += 1
    return out


def giou_rows_plain(
    pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel: per-row weighted GIoU loss."""
    return losses.iou_loss_rows(pred, target, "giou") * weight


class _GIoUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, weight):
        ctx.save_for_backward(pred, target, weight)
        return giou_rows_kernel(pred, target, weight)

    @staticmethod
    def backward(ctx, grad_rows):
        pred, target, weight = ctx.saved_tensors
        with torch.enable_grad():
            p = pred.detach().requires_grad_(True)
            rows = giou_rows_plain(p, target, weight)
            (dp,) = torch.autograd.grad(rows, p, grad_rows)
        return dp, None, None


def giou_loss(
    pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """Weighted SUM of per-row GIoU losses (ops.losses.iou_loss(..., "giou")).
    Leading dims are flattened. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if pred_ltrb.device.type == "cpu":
        return losses.iou_loss(pred_ltrb, target_ltrb, weight, "giou")
    rows = _GIoUFn.apply(
        pred_ltrb.reshape(-1, 4).contiguous(),
        target_ltrb.detach().reshape(-1, 4).contiguous(),
        weight.detach().reshape(-1).contiguous(),
    )
    return rows.sum()
