"""Multi-level FPN ROIAlignV2 (PyTorch port of ubteacher_tpu.ops.roi_align).

Semantics of the JAX package's exact path (`roi_align_matmul`): aligned
(half-pixel offset), bilinear sampling with positions clipped into the map,
an average over a sampling grid per bin, and for sampling_ratio 0 the
detectron2 adaptive grid of ceil(extent / P) samples per axis, capped at
ADAPTIVE_MAX_S. Each roi is pooled from the level of FPN eq. (1).

`multilevel_roi_align` keeps the JAX output layout (B, R, P, P, C). On CUDA
tensors it runs the kernels of ops/kernels/roi_align_cuda.py: the forward
through the op `ubt::roi_align_forward` (what torch.export traces), and
where the features need a gradient, the backward with respect to them
through an autograd.Function around that op. On CPU tensors the same op
runs the plain version, and where a gradient is needed the plain version is
called directly and differentiated by autograd. Boxes get no gradient:
proposals are detached.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .kernels import roi_align_cuda

ADAPTIVE_MAX_S = 8


def bin_sample_positions(
    start: torch.Tensor, extent: torch.Tensor, p: int, sampling_ratio: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-roi, per-bin sample positions and averaging coefficients along
    one axis. start, extent (N,) -> pos, coef (N, P, S) with sum_s coef = 1
    per bin; the slots of an adaptive grid smaller than S carry the bin's
    first position and coefficient 0."""
    dev = start.device
    # a tensor divisor: torch divides by a Python scalar on the GPU as a
    # multiplication by its reciprocal, which can put extent / P an ulp above
    # an integer (42 / 7 -> 6.0000005) and add a sample to the adaptive grid;
    # the CUDA kernel and the JAX package divide exactly
    bin_size = extent / torch.full_like(extent, float(p))
    if sampling_ratio > 0:
        max_s = sampling_ratio
        s = torch.full(start.shape, float(sampling_ratio), device=dev)
    else:
        max_s = ADAPTIVE_MAX_S
        s = torch.clamp(torch.ceil(bin_size), 1.0, float(max_s))
    i = torch.arange(max_s, dtype=torch.float32, device=dev)
    bins = torch.arange(p, dtype=torch.float32, device=dev)
    off = (i[None, :] + 0.5) / s[:, None]                 # (N, S) in bin units
    frac = bins[None, :, None] + off[:, None, :]          # (N, P, S)
    pos = start[:, None, None] + frac * bin_size[:, None, None]
    m = (i[None, None, :] < s[:, None, None]).expand(pos.shape)
    pos = torch.where(m, pos, pos[:, :, :1])
    coef = torch.where(m, 1.0 / s[:, None, None], torch.zeros((), device=dev))
    return pos, coef


def bin_axis_weights(pos: torch.Tensor, coef: torch.Tensor, length: int) -> torch.Tensor:
    """(N, P, length) bin-averaged bilinear weights relu(1 - |pos - h|) with
    the grid average folded in (the rows the JAX matmul formulation
    contracts the features with)."""
    grid = torch.arange(length, dtype=torch.float32, device=pos.device)
    w = torch.clamp(1.0 - torch.abs(pos[..., None] - grid), min=0.0)
    return (w * coef[..., None]).sum(dim=2)


def sample_coords(boxes: torch.Tensor, spatial_scale: float, output_size: int, sampling_ratio: int):
    """ys, cy, xs, cx (R, P, S): sample positions (aligned, in level pixels,
    not yet clipped) and coefficients along each axis."""
    x1 = boxes[:, 0] * spatial_scale - 0.5
    y1 = boxes[:, 1] * spatial_scale - 0.5
    x2 = boxes[:, 2] * spatial_scale - 0.5
    y2 = boxes[:, 3] * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=1e-6)
    roi_h = torch.clamp(y2 - y1, min=1e-6)
    ys, cy = bin_sample_positions(y1, roi_h, output_size, sampling_ratio)
    xs, cx = bin_sample_positions(x1, roi_w, output_size, sampling_ratio)
    return ys, cy, xs, cx


def assign_levels(
    boxes: torch.Tensor, min_level: int, max_level: int,
    canonical_level: int = 4, canonical_size: float = 224.0,
) -> torch.Tensor:
    """FPN eq. (1) as in detectron2's assign_boxes_to_levels; (R,) int32."""
    w = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0.0)
    h = torch.clamp(boxes[:, 3] - boxes[:, 1], min=0.0)
    sqrt_area = torch.clamp(torch.sqrt(w * h), min=1e-6)
    # exact division on every device (see bin_sample_positions)
    lvl = torch.floor(canonical_level + torch.log2(sqrt_area / torch.full_like(sqrt_area, canonical_size) + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


class _ROIAlignFn(torch.autograd.Function):
    """The CUDA forward and backward kernels; gradients reach the features
    only."""

    @staticmethod
    def forward(ctx, boxes, level, rois_per_image, scales, output_size, sampling_ratio, *feats):
        ctx.save_for_backward(boxes, level, *feats)
        ctx.args = (rois_per_image, scales, output_size, sampling_ratio)
        return torch.ops.ubt.roi_align_forward(list(feats), boxes, level, rois_per_image, scales, output_size,
                                               sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        boxes, level, *feats = ctx.saved_tensors
        rois_per_image, scales, output_size, sampling_ratio = ctx.args
        grads = roi_align_cuda.roi_align_backward_kernel(
            grad, feats, boxes, level, rois_per_image, scales, output_size, sampling_ratio
        )
        return (None,) * 6 + tuple(grads)


def multilevel_roi_align(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    levels: Sequence[int] = (2, 3, 4, 5),
    output_size: int = 7,
    sampling_ratio: int = 0,
) -> torch.Tensor:
    """feats: the pyramid levels `levels` (B, C, H_l, W_l); boxes (B, R, 4)
    xyxy image pixels -> (B, R, P, P, C) pooled from each roi's assigned
    level, in the feature dtype."""
    b, r, _ = boxes.shape
    flat = boxes.detach().reshape(b * r, 4).float().contiguous()
    level = (assign_levels(flat, min(levels), max(levels)) - min(levels)).contiguous()
    scales = [1.0 / 2**lv for lv in levels]
    cpu = flat.device.type == "cpu"
    feats = list(feats) if cpu else [f.contiguous() for f in feats]
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        if cpu:
            out = roi_align_cuda.roi_align_plain(feats, flat, level, r, scales, output_size, sampling_ratio)
        else:
            out = _ROIAlignFn.apply(flat, level, r, scales, output_size, sampling_ratio, *feats)
    else:
        out = torch.ops.ubt.roi_align_forward(feats, flat, level, r, scales, output_size, sampling_ratio)
    return out.reshape(b, r, *out.shape[1:])
