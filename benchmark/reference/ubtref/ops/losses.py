"""Loss functions, fixed-shape + masked (PyTorch port of ubteacher_tpu.ops.losses).

Every loss takes full-size inputs plus a weight/mask tensor and computes
masked sums, so no positive-index gathering happens anywhere. The focal and
IoU-family losses here are the plain versions of the hand-written kernels in
`ops/kernels/` (focal_triton, giou_cuda): the kernel wrappers use them for
CPU tensors and `chip_smoke.py` holds the kernels against them on the card.
"""

from __future__ import annotations

import math

import torch

from ..parallel import all_reduce_sum
from .boxes import ltrb_iou


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically-stable binary cross entropy with logits, elementwise:
    max(x, 0) - x * t + log(1 + exp(-|x|)).

    torch.maximum, not clamp: at x == 0 it splits the gradient between the
    two operands, so autograd gives d ce/dx = 0.5 - t there, the value the
    analytic focal gradient (focal_pallas.py:_bwd_kernel) uses."""
    return (
        torch.maximum(logits, logits.new_zeros(()))
        - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _bce_with_logits(logits, targets)


def sigmoid_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Per-element sigmoid focal loss, no reduction (fvcore RetinaNet form)."""
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def sigmoid_focal_loss_grad(
    logits: torch.Tensor,
    targets: torch.Tensor,
    grad_out: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Analytic d(focal)/d(logits) * grad_out, with the 1e-20 clamp on
    1 - p_t (ubteacher_tpu/ops/pallas/focal_pallas.py:_bwd_kernel). Plain
    version of the focal kernel's backward pass."""
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    one_m = torch.clamp(1.0 - p_t, min=1e-20)
    term = one_m**gamma * (p - targets) - gamma * one_m ** (gamma - 1.0) * p * (
        1.0 - p
    ) * (2.0 * targets - 1.0) * ce
    if alpha >= 0:
        term = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * term
    return term * grad_out


def iou_loss_rows(
    pred_ltrb: torch.Tensor,
    target_ltrb: torch.Tensor,
    loss_type: str = "giou",
) -> torch.Tensor:
    """Per-row IoU-family loss on aligned ltrb distances, (..., 4) -> (...),
    with the reference's (I+1)/(U+1) smoothing (layers/iou_loss.py:23-76)."""
    tl, tt, tr, tb = target_ltrb.unbind(-1)
    pl, pt, pr, pb = pred_ltrb.unbind(-1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_inter = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_inter = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w * g_h
    inter = w_inter * h_inter
    union = target_area + pred_area - inter
    ious = (inter + 1.0) / (union + 1.0)
    if loss_type == "iou":
        return -torch.log(torch.clamp(ious, min=1e-12))
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        safe_ac = torch.where(ac_union == 0, torch.ones_like(ac_union), ac_union)
        return 1.0 - (ious - (ac_union - union) / safe_ac)
    raise NotImplementedError(loss_type)


def giou_loss_grad(
    pred_ltrb: torch.Tensor,
    target_ltrb: torch.Tensor,
    weight: torch.Tensor,
    grad_rows: torch.Tensor,
) -> torch.Tensor:
    """Analytic d(iou_loss_rows(pred, target, "giou") * weight)/d(pred) *
    grad_rows, (N, 4) -> (N, 4), as jax.grad gives it for the JAX package's
    formula (the plain version of the GIoU backward kernel, csrc/giou.cu).
    minimum/maximum pass on the upstream gradient times 1 to the winning
    side, 1/2 to each side of a tie and 0 to the losing side or where an
    operand is NaN, multiplied, so that 0 x inf or NaN is NaN (JAX's rule;
    torch's masked_fill gives 0 there). The ac == 0 guard passes gradient to
    ac only where ac != 0. No row is skipped: a non-finite pred gives NaN
    where jax.grad does, weight 0 or not."""
    tl, tt, tr, tb = target_ltrb.unbind(-1)
    pl, pt, pr, pb = pred_ltrb.unbind(-1)
    target_area = (tl + tr) * (tt + tb)
    s_w, s_h = pl + pr, pt + pb
    w_inter = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_inter = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w * g_h
    inter = w_inter * h_inter
    union = target_area + s_w * s_h - inter
    num, den = inter + 1.0, union + 1.0
    safe_ac = torch.where(ac_union == 0, torch.ones_like(ac_union), ac_union)
    d = ac_union - union

    # rows = (1 - (num / den - d / safe_ac)) * weight
    grad_loss = grad_rows * weight
    grad_ious = -grad_loss
    grad_d = grad_loss / safe_ac
    grad_safe = -grad_loss * ((d / safe_ac) / safe_ac)
    grad_ac = grad_d + torch.where(ac_union == 0, torch.zeros_like(grad_safe), grad_safe)
    grad_union = -grad_d + -grad_ious * ((num / den) / den)
    grad_inter = grad_ious / den + -grad_union
    grad_w_inter, grad_h_inter = grad_inter * h_inter, grad_inter * w_inter
    grad_g_w, grad_g_h = grad_ac * g_h, grad_ac * g_w
    grad_s_w, grad_s_h = grad_union * s_h, grad_union * s_w

    def share(g, a, b, wins):
        return g * torch.where(a == b, 0.5, wins.to(g.dtype))

    # each coordinate sums its uses as autograd does: enclosing box,
    # intersection, then pred_area
    return torch.stack([
        share(grad_g_w, pl, tl, pl > tl) + share(grad_w_inter, pl, tl, pl < tl) + grad_s_w,
        share(grad_g_h, pt, tt, pt > tt) + share(grad_h_inter, pt, tt, pt < tt) + grad_s_h,
        share(grad_g_w, pr, tr, pr > tr) + share(grad_w_inter, pr, tr, pr < tr) + grad_s_w,
        share(grad_g_h, pb, tb, pb > tb) + share(grad_h_inter, pb, tb, pb < tb) + grad_s_h,
    ], -1)


def iou_loss(
    pred_ltrb: torch.Tensor,
    target_ltrb: torch.Tensor,
    weight: torch.Tensor | None = None,
    loss_type: str = "giou",
) -> torch.Tensor:
    """IoU-family loss on aligned ltrb distances; returns the weighted SUM.
    Invalid rows must carry weight 0."""
    losses = iou_loss_rows(pred_ltrb, target_ltrb, loss_type)
    if weight is not None:
        return (losses * weight).sum()
    return losses.sum()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Per-element smooth-L1; beta < 1e-5 degrades to pure L1."""
    n = torch.abs(pred - target)
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def kl_loss(
    pred: torch.Tensor,
    pred_std: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor | None = None,
    beta: float = 1.0,
    loss_denorm: torch.Tensor | float | None = None,
    method: str = "weight_ctr_sum",
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """KL-Loss uncertainty regression (reference layers/kl_loss.py:17-66):
    exp(-std) * smooth_l1 + 0.5 * std, summed over the 4 edges, then reduced
    per `method`; `valid` is the positives mask."""
    loss = torch.exp(-pred_std) * smooth_l1(pred, target, beta) + 0.5 * pred_std
    loss = loss.sum(-1)
    if valid is not None:
        loss = loss * valid
    if method == "weight_ctr_sum":
        return (loss * weight).sum()
    if method == "weight_ctr_mean":
        return (loss * weight).sum() / loss_denorm
    if method == "sum":
        return loss.sum()
    if method == "mean":  # over the (valid) instances of the global batch
        count = loss.new_full((), float(loss.numel())) if valid is None else valid.sum()
        return loss.sum() / torch.clamp(all_reduce_sum(count), min=1.0)
    raise ValueError(f"No defined regression loss method: {method}")


_TWO_LOG_2PI = 2.0 * math.log(2.0 * math.pi)


def nl_loss(
    pred: torch.Tensor,
    pred_std: torch.Tensor,
    target: torch.Tensor,
    iou_weight: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gaussian NLL with sigma = sigmoid(pred_std), IoU-weighted mean over
    the (valid) instances of the global batch (reference
    layers/kl_loss.py:75-105)."""
    sigma = torch.sigmoid(pred_std)
    sigma_sq = torch.clamp(sigma * sigma, min=1e-12)
    first = (target - pred) ** 2 / (2.0 * sigma_sq)
    second = 0.5 * torch.log(sigma_sq)
    per_inst = (first + second).sum(-1) + _TWO_LOG_2PI
    per_inst = per_inst * iou_weight
    if valid is None:
        count = per_inst.new_full((), float(per_inst.numel()))
    else:
        per_inst, count = per_inst * valid, valid.sum()
    return per_inst.sum() / torch.clamp(all_reduce_sum(count), min=1.0)


def compute_ctrness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """sqrt((min_lr / max_lr) * (min_tb / max_tb)); (..., 4) -> (...)."""
    lr = reg_targets[..., 0::2]  # slices: an index list is copied to the device
    tb = reg_targets[..., 1::2]
    ctr = (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-12)) * (
        tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-12)
    )
    return torch.sqrt(torch.clamp(ctr, min=0.0))


def compute_iou_targets(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Aligned ltrb IoU with +1 smoothing (fcos_outputs.py:91-129)."""
    return ltrb_iou(pred, target)
