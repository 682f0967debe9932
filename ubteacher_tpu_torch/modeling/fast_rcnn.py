"""Fast R-CNN box head: FC head, BoundaryVar output layers, proposal
sampling, losses and padded inference (PyTorch port of
ubteacher_tpu.modeling.fast_rcnn; reference roi_heads/fast_rcnn.py:715-1225
and roi_heads.py:141-270).

Everything is masked and fixed-shape: positives are weighted, never
gathered.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import losses as L
from ..ops.boxes import clip_boxes, matched_iou
from ..ops import nms as nms_ops
from ..structures import Detections, PaddedInstances
from .box_regression import Box2BoxXYXYTransform
from .matcher import NEG_INF, match, match_quality, topk_stable


class FastRCNNConvFCHead(nn.Module):
    """Flatten (P, P, C) -> fc1 -> relu -> fc2 -> relu (detectron2
    FastRCNNConvFCHead, NUM_FC fully connected layers of FC_DIM)."""

    def __init__(self, in_features: int, fc_dim: int = 1024, num_fc: int = 2):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_features if i == 0 else fc_dim, fc_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        # flax variance_scaling(1/3, fan_in, uniform): U(-1/sqrt(fan_in), +)
        for i in range(self.num_fc):
            fc = getattr(self, f"fc{i + 1}")
            bound = 1.0 / math.sqrt(fc.in_features)
            nn.init.uniform_(fc.weight, -bound, bound, generator=generator)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., P, P, C) -> (..., FC_DIM)."""
        x = x.reshape(*x.shape[:-3], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class BoundaryVarOutputLayers(nn.Module):
    """cls_score (K + 1), bbox_pred (4 class-agnostic, else 4K) and
    bbox_pred_std (the same width); outputs in float32 (reference
    fast_rcnn.py:759-789)."""

    def __init__(self, in_features: int = 1024, num_classes: int = 80, cls_agnostic: bool = True):
        super().__init__()
        reg_dim = 4 if cls_agnostic else 4 * num_classes
        self.cls_score = nn.Linear(in_features, num_classes + 1)
        self.bbox_pred = nn.Linear(in_features, reg_dim)
        self.bbox_pred_std = nn.Linear(in_features, reg_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        for m, std in ((self.cls_score, 0.01), (self.bbox_pred, 0.001), (self.bbox_pred_std, 0.0001)):
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x).float(), self.bbox_pred(x).float(), self.bbox_pred_std(x).float()


# --------------------------------------------------------------------------
# proposal sampling
# --------------------------------------------------------------------------


def sample_proposals(
    prop_boxes: torch.Tensor,
    prop_mask: torch.Tensor,
    gt: PaddedInstances,
    num_samples: int,
    positive_fraction: float,
    num_classes: int,
    priorities: torch.Tensor,
    append_gt: bool = True,
) -> Dict[str, torch.Tensor]:
    """label_and_sample_proposals[_pseudo] for a batch (reference
    roi_heads.py:141-270): append the gt boxes to the proposals, match at
    IoU >= 0.5 (plain torch, as the JAX package leaves it to XLA), and take
    num_samples with up to positive_fraction positives by random priority.

    prop_boxes (B, P, 4), prop_mask (B, P), gt (B, M); priorities (B, 2, n)
    uniform draws for the positive and the negative sampler, n = P + M with
    append_gt. Every chosen positive gets priority 3.0 and negatives
    1 + u, so the positives come first; topk_stable orders the tied
    positives by index, as lax.top_k does. Returns (B, num_samples) rows:
    boxes, valid, gt_classes, gt_boxes, gt_confid, gt_loc_std, is_fg."""
    if append_gt:
        boxes = torch.cat([prop_boxes, gt.boxes], 1)
        mask = torch.cat([prop_mask, gt.mask], 1)
    else:
        boxes, mask = prop_boxes, prop_mask
    dev = boxes.device
    quality = match_quality(gt.boxes, gt.mask, boxes)                          # (B, M, n)
    matched_idxs, matched_labels = match(quality, (0.5,), (0, 1), allow_low_quality=False)
    any_gt = gt.mask.any(-1, keepdim=True)
    gt_classes = torch.where(matched_labels == 1, torch.gather(gt.classes, 1, matched_idxs), num_classes)
    gt_classes = torch.where(any_gt, gt_classes, num_classes)

    n = boxes.shape[1]
    is_pos = (gt_classes != num_classes) & mask
    is_neg = (gt_classes == num_classes) & mask
    num_pos_desired = int(num_samples * positive_fraction)
    neg_inf = torch.full((), NEG_INF, device=dev)
    pos_pri = torch.where(is_pos, priorities[:, 0], neg_inf)
    _, pidx = topk_stable(pos_pri, min(num_pos_desired, n))
    chosen_pos = torch.zeros_like(is_pos).scatter_(1, pidx, True) & is_pos
    pri = torch.where(chosen_pos, torch.full((), 3.0, device=dev),
                      torch.where(is_neg, 1.0 + priorities[:, 1], neg_inf))
    vals, idx = topk_stable(pri, num_samples)
    valid = vals > NEG_INF / 2

    matched = torch.gather(matched_idxs, 1, idx)
    sampled_classes = torch.where(valid, torch.gather(gt_classes, 1, idx), num_classes)
    is_fg = (sampled_classes != num_classes) & valid
    zero = torch.zeros((), device=dev)

    def take_gt(x):
        if x.dim() == 2:
            return torch.where(any_gt, torch.gather(x, 1, matched), zero)
        return torch.where(any_gt[..., None], torch.gather(x, 1, matched[..., None].expand(-1, -1, 4)), zero)

    return {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "valid": valid,
        "gt_classes": sampled_classes,
        "gt_boxes": take_gt(gt.boxes),
        "gt_confid": take_gt(gt.scores),
        "gt_loc_std": take_gt(gt.box_std),
        "is_fg": is_fg,
    }


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def focal_ce_loss(
    scores: torch.Tensor,
    gt_classes: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 1.5,
    confid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Focal loss on the softmax CE (reference fast_rcnn.py:1405-1429),
    normalised by the number of sampled proposals (valid rows). ce is clamped
    at 0: a rounding of log_softmax a few ulps positive would make the
    fractional power NaN."""
    logp = F.log_softmax(scores, dim=-1)
    ce = -torch.gather(logp, 1, gt_classes[:, None])[:, 0]
    ce = torch.clamp(ce, min=0.0)
    p = torch.exp(-ce)
    loss = (1.0 - p) ** gamma * ce
    if confid is not None:
        loss = loss * confid
    loss = loss * valid
    return loss.sum() / torch.clamp(valid.sum().float(), min=1.0)


def cross_entropy_loss(scores: torch.Tensor, gt_classes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy, mean over the valid samples
    (MODEL.ROI_HEADS.LOSS 'CrossEntropy')."""
    logp = F.log_softmax(scores, dim=-1)
    ce = -torch.gather(logp, 1, gt_classes[:, None])[:, 0]
    return (ce * valid).sum() / torch.clamp(valid.sum().float(), min=1.0)


def box_reg_loss_smooth_l1(prop_boxes, gt_boxes, pred_deltas, is_fg, valid, box2box,
                           smooth_l1_beta: float = 0.0) -> torch.Tensor:
    """'smooth_l1' regression: sum over fg / total samples (reference
    fast_rcnn.py:961-968, 1016)."""
    fg = is_fg.float()
    gt_deltas = box2box.get_deltas(prop_boxes, gt_boxes)
    l1 = (L.smooth_l1(pred_deltas, gt_deltas, smooth_l1_beta).sum(-1) * fg).sum()
    return l1 / torch.clamp(valid.sum().float(), min=1.0)


def box_reg_loss_nll(prop_boxes, gt_boxes, pred_deltas, pred_deltas_std, is_fg, valid,
                     box2box: Box2BoxXYXYTransform, smooth_l1_beta: float = 0.0,
                     nll_weight: float = 0.05) -> torch.Tensor:
    """'nlloss' supervised regression: smooth-L1 (sum over fg) + 0.05 x the
    IoU-weighted Gaussian NLL (sum), / total samples (reference
    fast_rcnn.py:969-1016)."""
    fg = is_fg.float()
    gt_deltas = box2box.get_deltas(prop_boxes, gt_boxes)
    l1 = (L.smooth_l1(pred_deltas, gt_deltas, smooth_l1_beta).sum(-1) * fg).sum()
    pred_boxes = box2box.apply_deltas(pred_deltas, prop_boxes)
    iou_w = matched_iou(gt_boxes, pred_boxes)
    sigma = torch.sigmoid(pred_deltas_std)
    sigma_sq = torch.clamp(sigma * sigma, min=1e-12)
    first = (gt_deltas - pred_deltas) ** 2 / (2.0 * sigma_sq)
    second = 0.5 * torch.log(sigma_sq)
    per = (first + second).sum(-1) + 2.0 * math.log(2.0 * math.pi)
    nll = (per * iou_w * fg).sum()
    return (l1 + nll_weight * nll) / torch.clamp(valid.sum().float(), min=1.0)


def box_reg_pseudo_loss_tsbetter(prop_boxes, gt_boxes, pred_deltas, pred_deltas_std, gt_loc_std, is_fg,
                                 valid, box2box: Box2BoxXYXYTransform, ts_better: float,
                                 t_cert: float) -> torch.Tensor:
    """'tsbetter' pseudo regression: L1 only on the edges where the teacher's
    boundary confidence beats the student's by TS_BETTER and exceeds T_CERT
    (reference fast_rcnn.py:1055-1092)."""
    gt_deltas = box2box.get_deltas(prop_boxes, gt_boxes)
    gt_conf = 1.0 - torch.sigmoid(gt_loc_std)
    pred_conf = 1.0 - torch.sigmoid(pred_deltas_std)
    select = ((gt_conf > pred_conf + ts_better) & (gt_conf > t_cert) & is_fg[:, None]).float()
    l1 = (torch.abs(pred_deltas - gt_deltas) * select).sum()
    return l1 / torch.clamp(valid.sum().float(), min=1.0)


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------


@torch.no_grad()
def fast_rcnn_inference(
    prop_boxes: torch.Tensor,
    prop_mask: torch.Tensor,
    scores: torch.Tensor,
    deltas: torch.Tensor,
    deltas_std: torch.Tensor,
    image_hw: torch.Tensor,
    box2box: Box2BoxXYXYTransform,
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    total_candidates: int = 1000,
) -> Detections:
    """detectron2 fast_rcnn_inference at padded shapes, with the boundary
    uncertainty attached as box_std (reference fast_rcnn.py:1094-1125):
    (proposal, class) candidates above score_thresh, the top
    total_candidates of them, class-offset NMS over all images in one call
    of ops/nms.py, and the top topk_per_image kept."""
    b, p, k1 = scores.shape
    num_classes = k1 - 1
    hw = image_hw.float()
    probs = torch.softmax(scores, dim=-1)[..., :num_classes]                  # (B, P, K)
    pred_boxes = box2box.apply_deltas(deltas, prop_boxes)
    pred_boxes = clip_boxes(pred_boxes, hw[:, 0:1], hw[:, 1:2])
    cand = (probs > score_thresh) & prop_mask[..., None]
    flat = torch.where(cand, probs, -1.0).reshape(b, -1)
    cap = min(total_candidates, flat.shape[1])
    top, idx = topk_stable(flat, cap)
    pidx = idx // num_classes
    cidx = idx % num_classes
    cboxes = torch.gather(pred_boxes, 1, pidx[..., None].expand(-1, -1, 4))
    cstd = torch.gather(deltas_std, 1, pidx[..., None].expand(-1, -1, deltas_std.shape[-1]))
    cvalid = top > 0.0
    keep = nms_ops.batched_nms_keep(cboxes, top, cidx, cvalid, nms_thresh)
    kept, idx2 = topk_stable(torch.where(keep, top, nms_ops.NEG_INF), min(topk_per_image, cap))
    mask = kept > nms_ops.NEG_INF / 2
    zero = torch.zeros((), device=top.device)
    sel = torch.gather(top, 1, idx2)
    return Detections(
        boxes=torch.gather(cboxes, 1, idx2[..., None].expand(-1, -1, 4)),
        scores=torch.where(mask, sel, zero),
        classes=torch.gather(cidx, 1, idx2),
        cls_confid=torch.where(mask, sel, zero),
        centerness=torch.zeros_like(sel),
        box_std=torch.gather(cstd, 1, idx2[..., None].expand(-1, -1, cstd.shape[-1])),
        mask=mask,
        num_candidates=cvalid.sum(-1),
    )
