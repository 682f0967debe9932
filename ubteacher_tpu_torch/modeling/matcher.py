"""IoU matcher and fixed-size random subsampling, detectron2 semantics
(PyTorch port of ubteacher_tpu.modeling.matcher).

The matcher returns per-anchor labels and gt indices over all anchors; the
samplers return a fixed number of indices chosen by a top-k over random
priorities. The priorities are arguments (uniform [0, 1) draws, one per
position), so that the tests can feed in the JAX package's draws.

Top-k order: `topk_stable` breaks ties by the lower index, as lax.top_k does
(torch.topk promises no order among equal values), so every selection here
is the one the JAX package makes from the same priorities.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.boxes import pairwise_iou
from ..ops.kernels.matcher_cuda import match_anchors

NEG_INF = -1e9


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last dim, in
    descending order, equal values in ascending index order (lax.top_k's
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def match_quality(gt_boxes: torch.Tensor, gt_mask: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., M, A) with invalid gt rows forced to -1.
    gt_boxes (..., M, 4), gt_mask (..., M), anchors (A, 4) or (..., A, 4)."""
    lead = gt_boxes.shape[:-2]
    g = gt_boxes.reshape(-1, *gt_boxes.shape[-2:])
    a = anchors.reshape(-1, *anchors.shape[-2:]).expand(g.shape[0], -1, -1)
    # one image at a time: the (M, A, 2) corner intermediates of a whole
    # RPN batch would be several times the (B, M, A) result
    iou = torch.stack([pairwise_iou(gi, ai) for gi, ai in zip(g, a)])
    iou = iou.reshape(*lead, *iou.shape[1:])
    return torch.where(gt_mask[..., None], iou, torch.full((), -1.0, device=iou.device))


def match(
    quality: torch.Tensor,
    thresholds: Sequence[float],
    labels: Sequence[int],
    allow_low_quality: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Matcher over quality (..., M, A): per-anchor best gt (first
    argmax) and threshold-bucketed labels, int64 (..., A). With
    allow_low_quality, anchors reaching some gt's best quality (> 0) are
    promoted to the last label."""
    matched_vals = quality.amax(dim=-2)
    matched_idxs = quality.argmax(dim=-2)
    anchor_labels = torch.full(matched_vals.shape, labels[0], dtype=torch.int64, device=quality.device)
    for lo, lab in zip(thresholds, labels[1:]):
        anchor_labels = torch.where(matched_vals >= lo, lab, anchor_labels)
    if allow_low_quality:
        best_per_gt = quality.amax(dim=-1, keepdim=True)
        is_best = (quality == best_per_gt) & (best_per_gt > 0)
        anchor_labels = torch.where(is_best.any(dim=-2), labels[-1], anchor_labels)
    return matched_idxs, anchor_labels


def match_anchors_batched(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    thresholds: Sequence[float] = (0.3, 0.7),
    labels: Sequence[int] = (0, -1, 1),
    allow_low_quality: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN matcher for a batch: (matched_idxs, labels), each (B, A)
    int64. On CUDA tensors the matcher kernel (ops/kernels/matcher_cuda.py),
    bitwise equal to match_quality + match; on CPU tensors those two."""
    return match_anchors(
        anchors.contiguous(), gt_boxes.contiguous(), gt_mask.contiguous(),
        thresholds, labels, allow_low_quality,
    )


def random_priority_topk(
    eligible: torch.Tensor, k: int, priority: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample up to k eligible positions uniformly, fixed shape: the top k of
    `priority` (uniform draws) where eligible, NEG_INF elsewhere.
    eligible, priority (..., A) -> (idx (..., k), ok (..., k)), ok marking
    rows that hit an eligible position.

    The JAX package computes this top-k hierarchically once A >= 512 k (8
    rounds of per-block maxima, then a top-k of the survivors,
    matcher.py:129-146); that is exact unless more than 8 winners share an
    index residue, with probability below 1e-7 at the RPN's widths. The port
    takes the exact top-k over the same priorities."""
    k = min(k, eligible.shape[-1])
    pri = torch.where(eligible, priority, torch.full((), NEG_INF, device=priority.device))
    vals, idx = topk_stable(pri, k)
    return idx, vals > NEG_INF / 2


def sample_topk_indices(keep_priority: torch.Tensor, num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k indices by priority; the mask marks priorities > NEG_INF / 2."""
    vals, idx = topk_stable(keep_priority, num_samples)
    return idx, vals > NEG_INF / 2
