"""Fused ResNet stem, conv 7x7/s2 + folded FrozenBN + ReLU + max-pool 3x3/s2
(PyTorch port of ubteacher_tpu.ops.pallas.stem_pallas.stem_conv_pool).

`stem_conv_pool` keeps the JAX layout: x (B, H, W, 3) NHWC and the kernel
(7, 7, 3, C) HWIO in, (B, ceil(H/4), ceil(W/4), C) out in `dtype`. CPU
tensors take the plain version below; CUDA tensors the kernel of
ops/kernels/stem_cuda.py. Both are the implementations of the torch.library
op `ubt::stem_conv_pool`, whose shape function lets torch.export trace it.
Where an input needs a gradient the op runs inside an autograd.Function
whose backward differentiates the plain version, as the JAX custom_vjp
differentiates its XLA composition (stem_pallas.py:279-286); the stem is
frozen in every recipe, so that backward runs only where a caller unfreezes
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import stem_cuda


def stem_conv_pool_plain(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the scale folded into the
    weights in float32 and rounded to `dtype`, the image rounded to `dtype`,
    the conv summed in float32, the sum rounded to `dtype`, the bias added in
    `dtype`, ReLU, max-pool (padding taps never win). Autocast is off inside,
    so the dtypes are these under any caller."""
    with torch.autocast(x.device.type, enabled=False):
        k = (kernel.float() * scale.float()).to(dtype).float()
        xq = x.to(dtype).float().permute(0, 3, 1, 2)
        acc = F.conv2d(xq, k.permute(3, 2, 0, 1), stride=2, padding=3)
        y = torch.relu(acc.to(dtype) + bias.to(dtype)[:, None, None])
        return F.max_pool2d(y, 3, 2, 1).permute(0, 2, 3, 1)


@torch.library.custom_op("ubt::stem_conv_pool", mutates_args=(), device_types="cuda")
def _stem_op(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    return stem_cuda.stem_conv_pool_kernel(x, kernel, scale, bias, dtype)


@_stem_op.register_kernel("cpu")
def _(x, kernel, scale, bias, dtype):
    return stem_conv_pool_plain(x, kernel, scale, bias, dtype)


@_stem_op.register_fake
def _(x, kernel, scale, bias, dtype):
    b, h, w, _ = x.shape
    return x.new_empty((b, stem_cuda.pooled_size(h), stem_cuda.pooled_size(w), kernel.shape[3]), dtype=dtype)


class _StemConvPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, scale, bias, dtype):
        ctx.save_for_backward(x, kernel, scale, bias)
        ctx.dtype = dtype
        return torch.ops.ubt.stem_conv_pool(x, kernel, scale, bias, dtype)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            grads = torch.autograd.grad(stem_conv_pool_plain(*leaves, ctx.dtype), leaves, g)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)), None)


def stem_conv_pool(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused stem: x (B, H, W, 3) float32, kernel (7, 7, 3, C), scale and bias
    (C,) -> (B, ceil(H/4), ceil(W/4), C) in `dtype` (float32 or bfloat16)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, scale, bias)):
        return _StemConvPool.apply(x, kernel, scale, bias, dtype)
    return torch.ops.ubt.stem_conv_pool(x, kernel, scale, bias, dtype)
