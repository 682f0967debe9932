"""GIoU loss on aligned ltrb distances: the plain forward and its analytic
backward (the kernels' arithmetic), on any device."""

from __future__ import annotations

import torch

from .. import losses


def giou_rows_plain(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: per-row weighted GIoU loss."""
    return losses.iou_loss_rows(pred, target, "giou") * weight


def giou_rows_grad_plain(
    pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor, grad_rows: torch.Tensor
) -> torch.Tensor:
    """Plain version of the backward kernel: the analytic gradient of
    giou_rows_plain in pred, times grad_rows."""
    return losses.giou_loss_grad(pred, target, weight, grad_rows)


class _GIoUFn(torch.autograd.Function):
    """Per-row weighted GIoU loss, differentiable in pred."""

    @staticmethod
    def forward(ctx, pred, target, weight):
        ctx.save_for_backward(pred, target, weight)
        return giou_rows_plain(pred, target, weight)

    @staticmethod
    def backward(ctx, grad_rows):
        pred, target, weight = ctx.saved_tensors
        return giou_rows_grad_plain(pred, target, weight, grad_rows), None, None


def giou_loss(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted SUM of per-row GIoU losses (ops.losses.iou_loss(..., "giou")),
    differentiable in pred_ltrb only. Leading dims are flattened."""
    rows = _GIoUFn.apply(
        pred_ltrb.reshape(-1, 4).contiguous(),
        target_ltrb.detach().reshape(-1, 4).contiguous(),
        weight.detach().reshape(-1).contiguous(),
    )
    return rows.sum()
