"""Fixed-shape non-maximum suppression (PyTorch port of ubteacher_tpu.ops.nms).

All candidates live in padded (..., K) tensors with a validity mask; the
outputs keep static shape (a keep mask aligned with the inputs). Sorting, the
class-offset trick and the scatter back to input order run here in torch; the
greedy suppression itself is the CUDA kernel of ops/kernels/nms_cuda.py
(its plain version on the CPU). One call covers every image of a batch.
"""

from __future__ import annotations

import torch

from .kernels.nms_cuda import nms_sorted_keep

NEG_INF = -1e10


def nms_keep(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Exact greedy NMS (suppress IoU > t over the valid subset).
    (..., K, 4), (..., K), (..., K) -> keep mask (..., K) bool.

    Not differentiable: the inputs are detached."""
    lead, k = scores.shape[:-1], scores.shape[-1]
    boxes = boxes.detach().reshape(-1, k, 4).float()
    scores = scores.detach().reshape(-1, k)
    valid = valid.reshape(-1, k)
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    # stable, so equal scores keep input order as jnp.argsort does
    order = torch.argsort(-masked, dim=-1, stable=True)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    nvalid = valid.sum(-1, dtype=torch.int32)
    keep_sorted = nms_sorted_keep(sboxes, nvalid, iou_threshold)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep.reshape(*lead, k)


def batched_nms_keep(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Class-aware NMS per image via the coordinate-offset trick (detectron2
    batched_nms semantics). (B, K, 4), (B, K), (B, K), (B, K) -> (B, K)."""
    boxes = boxes.detach()
    masked_boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked_boxes.amax(dim=(-2, -1)) + 1.0  # (B,)
    offsets = classes.to(boxes.dtype) * max_coord[..., None]
    return nms_keep(boxes + offsets[..., None], scores, valid, iou_threshold)


def top_k_detections(keep: torch.Tensor, scores: torch.Tensor, post_nms_topk: int):
    """Indices of the top `post_nms_topk` kept candidates by score, per row.
    Returns (indices (..., k), mask (..., k))."""
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    top_scores, idx = torch.topk(masked, post_nms_topk, dim=-1)
    return idx, top_scores > NEG_INF / 2
