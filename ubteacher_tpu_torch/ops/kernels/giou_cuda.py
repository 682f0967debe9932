"""GIoU loss on aligned ltrb distances: the CUDA forward and backward kernels
(`csrc/giou.cu`) and their plain PyTorch versions.

Replaces ubteacher_tpu/ops/pallas/giou_pallas.py:giou_loss_pallas
(_fwd_kernel) and its VJP (jax.grad of the plain formula, which XLA fuses
into one pass), keeping the (I+1)/(U+1) smoothing and the `ac == 0` guard;
the gradient goes to the predictions only, not to the targets or the weight.

What bounds it on the H100: bytes moved, 40 bytes a row forward and 52
backward (the upstream gradient of rows.sum() is a stride-0 scalar), against
a few dozen flops; eager PyTorch runs the forward as some twenty elementwise
passes and autograd's backward as about ninety. So each direction is one
pass: a thread a row, the rows loaded as float4, every intermediate in
registers, the backward's chain rule written out by hand (the head of
csrc/giou.cu sets it out). The wrappers check only what the kernels need
and raise where it is missing; they neither copy nor fall back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import losses
from . import build

LAUNCHES = {"giou_fwd": 0, "giou_bwd": 0}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build.build("giou"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ubt_giou_fwd.argtypes = [p, p, p, i, p, i, p]
    lib.ubt_giou_bwd.argtypes = [p, p, p, p, ctypes.c_longlong, i, p, i, p]
    lib.ubt_giou_fwd.restype = lib.ubt_giou_bwd.restype = ctypes.c_int
    return lib


def _check(name: str, pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor, *more: torch.Tensor) -> int:
    """What the kernels need: one CUDA device, float32, contiguous (N, 4) rows
    at 16-byte aligned addresses (float4 loads) and contiguous (N,) weights.
    Returns N. Kept to a few attribute reads: it runs on every launch."""
    n = pred.shape[0] if pred.dim() == 2 else -1
    if pred.shape != (n, 4) or target.shape != (n, 4) or weight.shape != (n,):
        raise ValueError(
            f"{name}: expected (N, 4), (N, 4), (N,), got "
            f"{tuple(pred.shape)}, {tuple(target.shape)}, {tuple(weight.shape)}"
        )
    device = pred.get_device()  # -1 on the CPU
    for t in (pred, target, weight, *more):
        if device < 0 or t.get_device() != device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not (pred.is_contiguous() and target.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"{name}: pred, target and weight must be contiguous")
    if pred.data_ptr() % 16 or target.data_ptr() % 16:
        raise ValueError(f"{name}: pred and target rows must start at 16-byte aligned addresses")
    if 4 * n >= 2**31:
        raise ValueError(f"{name}: {n} rows exceed int32 offsets")
    return n


def _stream(device: int) -> int:
    """The current CUDA stream of `device`, as the raw handle (the cheapest
    lookup torch has; torch.cuda.current_stream builds a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device)


def giou_rows_kernel(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: (N, 4), (N, 4), (N,) -> per-row weighted
    loss (N,)."""
    n = _check("giou_rows_kernel", pred, target, weight)
    out = pred.new_empty((n,))
    if n:
        device = pred.get_device()
        err = _library().ubt_giou_fwd(pred.data_ptr(), target.data_ptr(), weight.data_ptr(), n,
                                      out.data_ptr(), device, _stream(device))
        if err != 0:
            raise RuntimeError(f"GIoU forward kernel launch failed: CUDA error {err}")
        LAUNCHES["giou_fwd"] += 1
    return out


def giou_rows_grad_kernel(
    pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor, grad_rows: torch.Tensor
) -> torch.Tensor:
    """Launch the backward kernel: d(rows)/d(pred) * grad_rows, (N, 4).
    grad_rows (N,) may have any stride (rows.sum() hands back stride 0)."""
    n = _check("giou_rows_grad_kernel", pred, target, weight, grad_rows)
    if grad_rows.shape != (n,):
        raise ValueError(f"giou_rows_grad_kernel: expected grad_rows ({n},), got {tuple(grad_rows.shape)}")
    dpred = torch.empty_like(pred)
    if n:
        device = pred.get_device()
        err = _library().ubt_giou_bwd(pred.data_ptr(), target.data_ptr(), weight.data_ptr(),
                                      grad_rows.data_ptr(), grad_rows.stride(0), n, dpred.data_ptr(),
                                      device, _stream(device))
        if err != 0:
            raise RuntimeError(f"GIoU backward kernel launch failed: CUDA error {err}")
        LAUNCHES["giou_bwd"] += 1
    return dpred


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
    """Per-row weighted GIoU loss, differentiable in pred: the kernels on
    CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, pred, target, weight):
        ctx.save_for_backward(pred, target, weight)
        if pred.device.type == "cpu":
            return giou_rows_plain(pred, target, weight)
        return giou_rows_kernel(pred, target, weight)

    @staticmethod
    def backward(ctx, grad_rows):
        pred, target, weight = ctx.saved_tensors
        if pred.device.type == "cpu":
            return giou_rows_grad_plain(pred, target, weight, grad_rows), None, None
        return giou_rows_grad_kernel(pred, target, weight, grad_rows), None, None


def giou_loss(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted SUM of per-row GIoU losses (ops.losses.iou_loss(..., "giou")),
    differentiable in pred_ltrb only. Leading dims are flattened."""
    rows = _GIoUFn.apply(
        pred_ltrb.reshape(-1, 4).contiguous(),
        target_ltrb.detach().reshape(-1, 4).contiguous(),
        weight.detach().reshape(-1).contiguous(),
    )
    return rows.sum()
