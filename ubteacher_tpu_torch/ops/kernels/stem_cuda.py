"""Fused ResNet stem (7x7/s2 conv + folded FrozenBN + ReLU + 3x3/s2 max-pool):
the CUDA kernel (`csrc/stem.cu`). Its plain PyTorch version is
ops/stem.py:stem_conv_pool_plain.

Replaces ubteacher_tpu/ops/pallas/stem_pallas.py:stem_conv_pool
(_stem_kernel). What bounds it on the H100 and what the design does about it
is set out at the head of csrc/stem.cu: bfloat16 output is an implicit GEMM
on the tensor cores, float32 output a direct conv on the CUDA cores. Both
read the image and the kernel at their own strides and fold the scale
themselves, so a call launches the kernel and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LAUNCHES = {"stem": 0}

STEM_CHANNELS = 64


class _Strides(ctypes.Structure):
    """csrc/stem.cu's UbtStemStrides: four element strides."""

    _fields_ = [("b", ctypes.c_longlong), ("h", ctypes.c_longlong), ("w", ctypes.c_longlong),
                ("c", ctypes.c_longlong)]


def bind(path: str) -> ctypes.CDLL:
    """Load a build of csrc/stem.cu and declare its C interface."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ubt_stem_conv_pool.argtypes = [i, p, _Strides, p, _Strides, p, p, i, i, i, p, p]
    lib.ubt_stem_conv_pool.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(build.build("stem"))


def pooled_size(n: int) -> int:
    """Output extent of the conv (stride 2, padding 3) then the pool (stride
    2, padding 1): ceil(ceil(n / 2) / 2)."""
    return ((n - 1) // 2) // 2 + 1


def stem_conv_pool_kernel(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA kernel. x (B, H, W, 3) float32 on a CUDA device, at
    any non-negative strides (the permuted view of an NCHW batch is read in
    place); kernel (7, 7, 3, 64) HWIO at any strides, scale and bias (64,),
    floating, on the same device; dtype float32 or bfloat16. Returns
    (B, ceil(H/4), ceil(W/4), 64) in `dtype`, contiguous."""
    if not x.is_cuda or any(t.device != x.device for t in (kernel, scale, bias)):
        raise ValueError("stem_conv_pool_kernel: tensors must be on one CUDA device")
    if x.dtype != torch.float32 or not all(t.is_floating_point() for t in (kernel, scale, bias)):
        raise TypeError(f"stem_conv_pool_kernel: expected a float32 image and float parameters, got {x.dtype}, "
                        f"{kernel.dtype}, {scale.dtype}, {bias.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem_conv_pool_kernel: dtype must be float32 or bfloat16, got {dtype}")
    c = STEM_CHANNELS
    if (x.dim() != 4 or x.shape[3] != 3 or tuple(kernel.shape) != (7, 7, 3, c)
            or tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,)):
        raise ValueError(f"stem_conv_pool_kernel: expected x (B, H, W, 3), kernel (7, 7, 3, {c}), scale and bias "
                         f"({c},), got {tuple(x.shape)}, {tuple(kernel.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    # float32 parameters: no copy when they are so already (the model's are)
    kernel, scale, bias = kernel.float(), scale.float().contiguous(), bias.float().contiguous()
    if any(st < 0 for st in x.stride() + kernel.stride()):
        raise ValueError(f"stem_conv_pool_kernel: strides {x.stride()}, {kernel.stride()} must be non-negative")
    b, h, w, _ = x.shape
    if h < 1 or w < 1 or b >= 2**16:
        raise ValueError(f"stem_conv_pool_kernel: B={b}, H={h}, W={w} outside the launch limits")
    out = torch.empty((b, pooled_size(h), pooled_size(w), c), dtype=dtype, device=x.device)
    if b == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # the kernel folds the scale in float32 and rounds the weights and the
        # bias to `dtype` (stem_pallas.py:_fold_weights)
        err = lib.ubt_stem_conv_pool(int(dtype == torch.bfloat16), x.data_ptr(), _Strides(*x.stride()),
                                     kernel.data_ptr(), _Strides(*kernel.stride()), scale.data_ptr(),
                                     bias.data_ptr(), b, h, w, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    LAUNCHES["stem"] += 1
    return out
