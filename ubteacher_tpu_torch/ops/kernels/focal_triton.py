"""Sigmoid focal loss, forward and backward, as Triton kernels.

Replaces ubteacher_tpu/ops/pallas/focal_pallas.py:sigmoid_focal_loss_pallas
(_fwd_kernel, _bwd_kernel).

What bounds it on the H100: bytes moved. The forward reads logits and targets
and writes the loss (12 bytes per element), the backward reads three tensors
and writes one (16 bytes per element), against a few dozen flops of
sigmoid/exp/log per element. Eager PyTorch would run the formula as about ten
separate elementwise passes each way, each one a full round trip of the
(B*L, C) tensor through device memory.

What the design does about it: one flat pass per direction over the N*C
elements in 1-D blocks of 1024, with masked contiguous loads (coalesced,
16 bytes per thread), keeping every intermediate (p, ce, p_t) in registers.
The backward is the analytic gradient of focal_pallas.py:33-54, including
the 1e-20 clamp on 1 - p_t.

The kernel sources live in `_focal_jit.py`, imported on first launch only.
"""

from __future__ import annotations

import torch

from .. import losses

LAUNCHES = {"focal_fwd": 0, "focal_bwd": 0}

_BLOCK = 1024


def _check(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if ref.numel() >= 2**31:
        raise ValueError(f"{name}: {ref.numel()} elements exceed int32 offsets")


def focal_forward_kernel(
    logits: torch.Tensor, targets: torch.Tensor, alpha: float, gamma: float
) -> torch.Tensor:
    """Launch the forward kernel: per-element loss, same shape as logits."""
    _check("focal_forward_kernel", logits, targets)
    from . import _focal_jit

    out = torch.empty_like(logits)
    n = logits.numel()
    if n:
        grid = ((n + _BLOCK - 1) // _BLOCK,)
        with torch.cuda.device(logits.device):
            _focal_jit.focal_fwd_kernel[grid](
                logits, targets, out, n, float(alpha),
                GAMMA=float(gamma), USE_ALPHA=alpha >= 0, BLOCK=_BLOCK,
                num_warps=4,
            )
        LAUNCHES["focal_fwd"] += 1
    return out


def focal_backward_kernel(
    logits: torch.Tensor,
    targets: torch.Tensor,
    grad_out: torch.Tensor,
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """Launch the backward kernel: d(loss)/d(logits) * grad_out."""
    _check("focal_backward_kernel", logits, targets, grad_out)
    from . import _focal_jit

    dx = torch.empty_like(logits)
    n = logits.numel()
    if n:
        grid = ((n + _BLOCK - 1) // _BLOCK,)
        with torch.cuda.device(logits.device):
            _focal_jit.focal_bwd_kernel[grid](
                logits, targets, grad_out, dx, n, float(alpha),
                GAMMA=float(gamma), USE_ALPHA=alpha >= 0, BLOCK=_BLOCK,
                num_warps=4,
            )
        LAUNCHES["focal_bwd"] += 1
    return dx


class _FocalFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, alpha, gamma):
        ctx.save_for_backward(logits, targets)
        ctx.alpha, ctx.gamma = alpha, gamma
        return focal_forward_kernel(logits, targets, alpha, gamma)

    @staticmethod
    def backward(ctx, grad_out):
        logits, targets = ctx.saved_tensors
        # the upstream sum(-1) hands back an expanded (stride-0) gradient
        dx = focal_backward_kernel(
            logits, targets, grad_out.contiguous(), ctx.alpha, ctx.gamma
        )
        return dx, None, None, None


def sigmoid_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Per-element sigmoid focal loss, same semantics as
    ops.losses.sigmoid_focal_loss; differentiable in `logits` only (targets
    are labels). CPU tensors take the plain version; CUDA tensors the
    kernels."""
    if logits.device.type == "cpu":
        return losses.sigmoid_focal_loss(logits, targets, alpha, gamma)
    return _FocalFn.apply(logits, targets.detach(), alpha, gamma)
