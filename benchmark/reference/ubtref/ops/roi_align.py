"""Multi-level FPN ROIAlignV2, plain PyTorch: the port's semantics
(`ops/roi_align.py`: aligned, bilinear samples clipped into the map, the
average of a sampling grid per bin, detectron2's adaptive grid of
ceil(extent / P) samples per axis capped at ADAPTIVE_MAX_S, each roi pooled
from the level of FPN eq. (1)), written as the JAX package's exact
`roi_align_matmul`: each roi's bin-averaged bilinear weights along y and
along x, contracted with its image's map. The backward is the transposed
contraction, written out, so that nothing of the size of a sample grid is
kept for it: at 24 images x 512 rois autograd's saved gathers would not
fit on the card."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

ADAPTIVE_MAX_S = 8
ROI_CHUNK = 128


def bin_sample_positions(start: torch.Tensor, extent: torch.Tensor, p: int,
                         sampling_ratio: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-roi, per-bin sample positions and averaging coefficients along
    one axis. start, extent (N,) -> pos, coef (N, P, S), sum_s coef = 1 per
    bin; the slots of an adaptive grid smaller than S carry the bin's first
    position and coefficient 0."""
    dev = start.device
    bin_size = extent / torch.full_like(extent, float(p))
    if sampling_ratio > 0:
        max_s = sampling_ratio
        s = torch.full(start.shape, float(sampling_ratio), device=dev)
    else:
        max_s = ADAPTIVE_MAX_S
        s = torch.clamp(torch.ceil(bin_size), 1.0, float(max_s))
    i = torch.arange(max_s, dtype=torch.float32, device=dev)
    bins = torch.arange(p, dtype=torch.float32, device=dev)
    off = (i[None, :] + 0.5) / s[:, None]
    frac = bins[None, :, None] + off[:, None, :]
    pos = start[:, None, None] + frac * bin_size[:, None, None]
    m = (i[None, None, :] < s[:, None, None]).expand(pos.shape)
    pos = torch.where(m, pos, pos[:, :, :1])
    coef = torch.where(m, 1.0 / s[:, None, None], torch.zeros((), device=dev))
    return pos, coef


def axis_weights(start: torch.Tensor, extent: torch.Tensor, p: int, sampling_ratio: int,
                 length: int) -> torch.Tensor:
    """(N, P, length): each bin's average of the bilinear weights
    relu(1 - |pos - h|) of its samples, positions clipped into [0, length - 1]."""
    pos, coef = bin_sample_positions(start, extent, p, sampling_ratio)
    pos = pos.clamp(0.0, length - 1.0)
    grid = torch.arange(length, dtype=torch.float32, device=pos.device)
    w = torch.clamp(1.0 - torch.abs(pos[..., None] - grid), min=0.0)
    return (w * coef[..., None]).sum(dim=2)


def roi_weights(boxes: torch.Tensor, scale: float, p: int, sampling_ratio: int, h: int, w: int):
    """(wy (N, P, h), wx (N, P, w)) of boxes (N, 4) xyxy image pixels on a
    level of 1 / `scale` stride."""
    x1 = boxes[:, 0] * scale - 0.5
    y1 = boxes[:, 1] * scale - 0.5
    x2 = boxes[:, 2] * scale - 0.5
    y2 = boxes[:, 3] * scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=1e-6)
    roi_h = torch.clamp(y2 - y1, min=1e-6)
    return axis_weights(y1, roi_h, p, sampling_ratio, h), axis_weights(x1, roi_w, p, sampling_ratio, w)


def assign_levels(boxes: torch.Tensor, min_level: int, max_level: int, canonical_level: int = 4,
                  canonical_size: float = 224.0) -> torch.Tensor:
    """FPN eq. (1) as in detectron2's assign_boxes_to_levels; (R,) int32."""
    w = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0.0)
    h = torch.clamp(boxes[:, 3] - boxes[:, 1], min=0.0)
    sqrt_area = torch.clamp(torch.sqrt(w * h), min=1e-6)
    lvl = torch.floor(canonical_level + torch.log2(sqrt_area / torch.full_like(sqrt_area, canonical_size) + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


def _groups(level: torch.Tensor, rois_per_image: int, count: int):
    """(level, image, roi indices) of each non-empty (image, level) group."""
    img = torch.arange(level.shape[0], device=level.device) // rois_per_image
    key = (img * count + level.long()).tolist()
    groups = {}
    for i, k in enumerate(key):
        groups.setdefault(k, []).append(i)
    for k, idx in sorted(groups.items()):
        yield k % count, k // count, torch.tensor(idx, device=level.device)


class _ROIAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, boxes, level, rois_per_image, scales, p, sampling_ratio, *feats):
        ctx.save_for_backward(boxes, level)
        ctx.args = (rois_per_image, scales, p, sampling_ratio, [f.shape for f in feats], feats[0].dtype)
        n, c = boxes.shape[0], feats[0].shape[1]
        out = torch.zeros((n, p, p, c), dtype=torch.float32, device=boxes.device)
        for lv, img, sel in _groups(level, rois_per_image, len(feats)):
            f = feats[lv][img].float()  # (C, H, W)
            h, w = f.shape[1:]
            for part in sel.split(ROI_CHUNK):
                wy, wx = roi_weights(boxes[part], scales[lv], p, sampling_ratio, h, w)
                t = torch.einsum("chw,nqw->nchq", f, wx)
                out[part] = torch.einsum("nph,nchq->npqc", wy, t)
        return out.to(feats[0].dtype)

    @staticmethod
    def backward(ctx, grad):
        boxes, level = ctx.saved_tensors
        rois_per_image, scales, p, sampling_ratio, shapes, dtype = ctx.args
        grads = [torch.zeros(s, dtype=torch.float32, device=grad.device) for s in shapes]
        g = grad.float()
        for lv, img, sel in _groups(level, rois_per_image, len(shapes)):
            h, w = shapes[lv][2:]
            for part in sel.split(ROI_CHUNK):
                wy, wx = roi_weights(boxes[part], scales[lv], p, sampling_ratio, h, w)
                t = torch.einsum("nph,npqc->nchq", wy, g[part])
                grads[lv][img] += torch.einsum("nchq,nqw->chw", t, wx)
        return (None,) * 6 + tuple(x.to(dtype) for x in grads)


def multilevel_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor, levels: Sequence[int] = (2, 3, 4, 5),
                         output_size: int = 7, sampling_ratio: int = 0) -> torch.Tensor:
    """feats: the pyramid levels `levels` (B, C, H_l, W_l); boxes (B, R, 4)
    xyxy image pixels -> (B, R, P, P, C) pooled from each roi's assigned
    level, in the feature dtype; differentiable in the features."""
    b, r, _ = boxes.shape
    flat = boxes.detach().reshape(b * r, 4).float()
    level = assign_levels(flat, min(levels), max(levels)) - min(levels)
    scales: List[float] = [1.0 / 2**lv for lv in levels]
    out = _ROIAlign.apply(flat, level, r, scales, output_size, sampling_ratio, *feats)
    return out.reshape(b, r, *out.shape[1:])
