"""Region Proposal Network: head, anchor labeling, losses and proposal
selection (PyTorch port of ubteacher_tpu.modeling.rpn; reference
proposal_generator/rpn.py:15-225).

Fixed shapes as in the JAX package: anchors are a per-canvas constant,
labeling samples a fixed number of anchors by random-priority top-k,
proposals come out padded (B, POST_NMS_TOPK) with a mask, and the pseudo
branch's confidence-weighted objectness is a weight, not a gather.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import losses as L
from ..ops.boxes import clip_boxes
from ..ops.nms import nms_keep
from ..ops.row_gather import take_rows
from ..structures import PaddedInstances
from .box_regression import Box2BoxTransform
from .matcher import random_priority_topk, topk_stable


class RPNHead(nn.Module):
    """Shared 3x3 conv, then 1x1 objectness and deltas (detectron2
    StandardRPNHead). Per level the outputs become (B, H*W, A) and
    (B, H*W, A, 4): locations row-major over the map, the cell anchor
    innermost, the anchor order of modeling/anchors.py."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3, conv_dim: int = 256):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(in_channels, conv_dim, 3, padding=1)
        self.objectness_logits = nn.Conv2d(conv_dim, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(conv_dim, num_anchors * 4, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.conv, self.objectness_logits, self.anchor_deltas):
            nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(m.bias)

    def forward(self, features: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        a = self.num_anchors
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            lo = self.objectness_logits(t).float()            # (B, A, H, W)
            de = self.anchor_deltas(t).float()                # (B, 4A, H, W)
            logits.append(lo.permute(0, 2, 3, 1).reshape(b, -1, a))
            deltas.append(de.permute(0, 2, 3, 1).reshape(b, -1, a, 4))
        return logits, deltas


def anchor_validity(cell_origins: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """(B, A) bool: anchors whose feature-map cell overlaps the true image
    (a cell at origin o covers [o, o + stride)). cell_origins (A, 2) (x, y),
    hw (B, 2) (h, w)."""
    return (cell_origins[None, :, 0] < hw[:, 1:2]) & (cell_origins[None, :, 1] < hw[:, 0:1])


def label_anchors(
    gt: PaddedInstances,
    batch_size_per_image: int,
    positive_fraction: float,
    priorities: torch.Tensor,
    use_confidence,
    anchor_valid: torch.Tensor,
    matched: Tuple[torch.Tensor, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Subsample the matched anchors of a batch (reference rpn.py:78-150),
    sample first: only the K = num_pos + batch_size_per_image rows per image
    are built, of which min(batch_size_per_image, available) carry ok.

    gt (B, M); priorities (B, 2, A) uniform draws for the positive and the
    negative sampler; use_confidence a bool or a (B,) bool tensor; anchor_valid
    (B, A); matched (matched_idxs, labels) (B, A) from match_anchors_batched.
    Returns idx (B, K) anchor indices, labels (B, K) {1, 0}, ok (B, K),
    boxes (B, K, 4) matched gt, confid (B, K) teacher scores (ones without
    confidence weighting)."""
    matched_idxs, labels = matched
    dev = labels.device
    num_pos_desired = int(batch_size_per_image * positive_fraction)
    pos_cand = (labels == 1) & anchor_valid
    neg_cand = (labels == 0) & anchor_valid
    pos_idx, pos_ok = random_priority_topk(pos_cand, num_pos_desired, priorities[:, 0])
    n_pos = pos_ok.sum(-1, keepdim=True)
    neg_idx, neg_avail = random_priority_topk(neg_cand, batch_size_per_image, priorities[:, 1])
    neg_ok = (torch.arange(neg_idx.shape[-1], device=dev) < batch_size_per_image - n_pos) & neg_avail

    idx = torch.cat([pos_idx, neg_idx], -1)
    sel_labels = torch.cat([torch.ones_like(pos_idx), torch.zeros_like(neg_idx)], -1)
    ok = torch.cat([pos_ok, neg_ok], -1)
    # an image with no valid gt has quality -1 everywhere, so no positives
    any_gt = gt.mask.any(-1, keepdim=True)
    mi = torch.gather(matched_idxs, 1, idx)
    zero = torch.zeros((), device=dev)
    boxes = torch.where(any_gt[..., None], torch.gather(gt.boxes, 1, mi[..., None].expand(-1, -1, 4)), zero)
    use_conf = torch.as_tensor(use_confidence, device=dev).reshape(-1, 1)
    confid = torch.where(
        use_conf,
        torch.where(any_gt, torch.gather(gt.scores, 1, mi), zero),
        torch.ones((), device=dev),
    )
    return {"idx": idx, "labels": sel_labels, "ok": ok, "boxes": boxes, "confid": confid}


def rpn_losses(
    anchors: torch.Tensor,
    pred_logits: torch.Tensor,
    pred_deltas: torch.Tensor,
    sampled: Dict[str, torch.Tensor],
    box2box: Box2BoxTransform,
    batch_size_per_image: int,
    smooth_l1_beta: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Sum BCE + smooth-L1 over the sampled anchors, normalised by
    batch_size_per_image * num_images (reference rpn.py:153-225).
    pred_logits (B, L, A), pred_deltas (B, L, A, 4). The predictions are
    gathered at the sampled anchors' locations with take_rows (backward: the
    row-scatter kernel) and their cell anchor picked by a one-hot."""
    num_images, l, a_cell = pred_logits.shape
    idx = sampled["idx"]
    pos = (sampled["labels"] == 1) & sampled["ok"]
    valid = sampled["ok"]

    rows = idx // a_cell
    lane_onehot = F.one_hot(idx % a_cell, a_cell).to(pred_logits.dtype)          # (B, K, A)
    logits_s = (take_rows(pred_logits, rows) * lane_onehot).sum(-1)              # (B, K)
    deltas_rows = take_rows(pred_deltas.reshape(num_images, l, a_cell * 4), rows)
    deltas_s = (deltas_rows.reshape(num_images, -1, a_cell, 4) * lane_onehot[..., None]).sum(-2)
    anchors_s = anchors[idx]                                                     # (B, K, 4)

    target_deltas = box2box.get_deltas(anchors_s, sampled["boxes"])
    loc = L.smooth_l1(deltas_s, target_deltas, smooth_l1_beta).sum(-1)
    localization_loss = (loc * pos).sum()

    obj = L.bce_with_logits(logits_s, pos.float()) * sampled["confid"]
    objectness_loss = (obj * valid).sum()

    normalizer = batch_size_per_image * num_images
    return {
        "loss_rpn_cls": objectness_loss / normalizer,
        "loss_rpn_loc": localization_loss / normalizer,
    }


@torch.no_grad()
def find_top_proposals(
    anchors: torch.Tensor,
    level_lengths: Sequence[int],
    pred_logits: torch.Tensor,
    pred_deltas: torch.Tensor,
    image_hw: torch.Tensor,
    box2box: Box2BoxTransform,
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_thresh: float,
    total_candidates: int = 2000,
    cell_origins: torch.Tensor | None = None,
    min_size: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """detectron2 find_top_rpn_proposals at fixed shape: per-level top-k by
    objectness, decode, clip, MIN_SIZE, per-level NMS, global top-k. Returns
    (boxes (B, P, 4), scores (B, P), mask (B, P)); carries no gradient.

    The per-level top-k is two-stage and exact (an anchor in a level's top-k
    lies in the top-k locations by per-location max). The levels' candidate
    pools are stacked as rows, short levels padded invalid, and NMS runs
    over all images and levels in one call of ops/nms.py."""
    b, _, a_cell = pred_logits.shape
    hw = image_hw.float()
    if cell_origins is not None:
        loc_valid = anchor_validity(cell_origins[::a_cell], hw)               # (B, L)
        pred_logits = torch.where(loc_valid[..., None], pred_logits, float("-inf"))
    per_level_cap = max(total_candidates, 1)
    k_max = max(min(pre_nms_topk, per_level_cap, ln) for ln in level_lengths)
    flat_deltas = pred_deltas.reshape(b, -1, 4)
    sel_scores, sel_boxes = [], []
    loc_offset = 0
    for ln in level_lengths:
        nloc = ln // a_cell
        k = min(pre_nms_topk, per_level_cap, ln)
        lvl_scores = pred_logits[:, loc_offset:loc_offset + nloc]           # (B, nloc, A)
        _, loc_sel = topk_stable(lvl_scores.amax(-1), min(k, nloc))           # (B, k_loc)
        flat = torch.gather(lvl_scores, 1, loc_sel[..., None].expand(-1, -1, a_cell)).reshape(b, -1)
        top, idx = topk_stable(flat, k)                                       # (B, k)
        row_abs = torch.gather(loc_sel, 1, idx // a_cell) + loc_offset
        aidx = row_abs * a_cell + idx % a_cell
        lvl_deltas = torch.gather(flat_deltas, 1, aidx[..., None].expand(-1, -1, 4))
        boxes = box2box.apply_deltas(lvl_deltas, anchors[aidx])
        boxes = clip_boxes(boxes, hw[:, 0:1], hw[:, 1:2])
        pad = k_max - k
        sel_scores.append(F.pad(top, (0, pad), value=float("-inf")))
        sel_boxes.append(F.pad(boxes, (0, 0, 0, pad)))
        loc_offset += nloc
    scores = torch.stack(sel_scores, 1)                                       # (B, NL, K_max)
    boxes = torch.stack(sel_boxes, 1)                                         # (B, NL, K_max, 4)
    # detectron2 drops boxes left degenerate by clipping (strict > MIN_SIZE)
    nonempty = (boxes[..., 2] - boxes[..., 0] > min_size) & (boxes[..., 3] - boxes[..., 1] > min_size)
    scores = torch.where(nonempty, scores, float("-inf"))
    keep = nms_keep(boxes, scores, torch.isfinite(scores), nms_thresh)       # one launch, B*NL rows
    scores = torch.where(keep, scores, float("-inf")).reshape(b, -1)
    boxes = boxes.reshape(b, -1, 4)
    top2, idx2 = topk_stable(scores, min(post_nms_topk, scores.shape[1]))
    mask = torch.isfinite(top2)
    out_boxes = torch.gather(boxes, 1, idx2[..., None].expand(-1, -1, 4))
    return out_boxes, torch.where(mask, top2, 0.0), mask
