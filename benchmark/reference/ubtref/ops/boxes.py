"""Box geometry ops, vectorized and fixed-shape (PyTorch port of
ubteacher_tpu.ops.boxes). All functions broadcast over leading batch dims."""

from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; (..., 4) -> (...)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU between all pairs; (N, 4) x (M, 4) -> (N, M), xyxy."""
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[:, None] + a2[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)


def matched_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Element-wise IoU of aligned box tensors; (..., 4) x (..., 4) -> (...)."""
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)


def ltrb_iou(pred: torch.Tensor, target: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """IoU of aligned (l, t, r, b) distance boxes sharing a center, with the
    reference's (I + 1) / (U + 1) smoothing (fcos_outputs.py:91-129)."""
    tl, tt, tr, tb = target.unbind(-1)
    pl, pt, pr, pb = pred.unbind(-1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_inter = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_inter = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    inter = w_inter * h_inter
    union = target_area + pred_area - inter
    return (inter + smooth) / (union + smooth)


def decode_ltrb(locations: torch.Tensor, ltrb: torch.Tensor) -> torch.Tensor:
    """(x, y) locations + (l, t, r, b) distances -> xyxy boxes."""
    x, y = locations[..., 0], locations[..., 1]
    return torch.stack(
        [x - ltrb[..., 0], y - ltrb[..., 1], x + ltrb[..., 2], y + ltrb[..., 3]],
        dim=-1,
    )


def encode_ltrb(locations: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(x, y) locations + xyxy boxes -> (l, t, r, b) distances; broadcasts
    (L, 1, 2) x (1, M, 4) -> (L, M, 4)."""
    x, y = locations[..., 0], locations[..., 1]
    return torch.stack(
        [x - boxes[..., 0], y - boxes[..., 1], boxes[..., 2] - x, boxes[..., 3] - y],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, height: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Clamp xyxy boxes into [0, w] x [0, h]; height/width broadcast against
    boxes[..., 0] (pass (B, 1) tensors for per-image sizes)."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), width)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), height)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), width)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), height)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def mask_canvas_padding(x: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """Zero a (B, H, W, C) normalized canvas beyond each image's true (h, w):
    the reference normalizes and then zero-pads, so padding is exactly 0 in
    normalized space."""
    b, h, w = x.shape[:3]
    hwf = hw.to(x.dtype)
    rows = torch.arange(h, dtype=x.dtype, device=x.device)
    cols = torch.arange(w, dtype=x.dtype, device=x.device)
    valid = (rows[None, :, None] < hwf[:, 0].reshape(b, 1, 1)) & (
        cols[None, None, :] < hwf[:, 1].reshape(b, 1, 1)
    )
    return x * valid[..., None].to(x.dtype)
