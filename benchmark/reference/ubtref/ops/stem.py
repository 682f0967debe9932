"""Fused ResNet stem, conv 7x7/s2 + folded FrozenBN + ReLU + max-pool 3x3/s2
(PyTorch port of ubteacher_tpu.ops.pallas.stem_pallas.stem_conv_pool).

`stem_conv_pool` keeps the JAX layout: x (B, H, W, 3) NHWC and the kernel
(7, 7, 3, C) HWIO in, (B, ceil(H/4), ceil(W/4), C) out in `dtype`; here
always the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def stem_conv_pool(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused stem, plain: x (B, H, W, 3) float32, kernel (7, 7, 3, C), scale
    and bias (C,) -> (B, ceil(H/4), ceil(W/4), C) in `dtype`."""
    return stem_conv_pool_plain(x, kernel, scale, bias, dtype)
