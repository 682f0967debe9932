"""Box-proposal recall metrics (AR@N by area), host-side numpy (the port's
copy of ubteacher_tpu.evaluation.proposal_eval).

Replicates the reference's `_evaluate_box_proposals`
(ubteacher/evaluation/coco_evaluation.py:441-554): greedy
best-IoU bipartite matching between score-sorted proposals and non-crowd
gt, max-overlap per gt accumulated over the dataset, recall averaged over
IoU thresholds 0.50:0.05:0.95. The reference's `_eval_box_proposals`
(:258-301) reports AR{,s,m,l}@{100,1000}.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

_AREAS = {
    "all": (0.0**2, 1e5**2),
    "small": (0.0**2, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e5**2),
    "96-128": (96.0**2, 128.0**2),
    "128-256": (128.0**2, 256.0**2),
    "256-512": (256.0**2, 512.0**2),
    "512-inf": (512.0**2, 1e5**2),
}


def _pairwise_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def evaluate_box_proposals(
    records: List[Dict],
    thresholds: Optional[Sequence[float]] = None,
    area: str = "all",
    limit: Optional[int] = None,
) -> Dict:
    """records: per-image dicts with
      proposal_boxes (N, 4) xyxy, objectness (N,),
      gt_boxes (M, 4) xyxy NON-CROWD only, gt_areas (M,).
    Returns {ar, recalls, thresholds, gt_overlaps, num_pos}."""
    area_range = _AREAS[area]
    gt_overlaps = []
    num_pos = 0

    for rec in records:
        boxes = np.asarray(rec["proposal_boxes"], np.float64).reshape(-1, 4)
        obj = np.asarray(rec["objectness"], np.float64).reshape(-1)
        order = np.argsort(-obj, kind="stable")
        boxes = boxes[order]

        gt_boxes = np.asarray(rec["gt_boxes"], np.float64).reshape(-1, 4)
        gt_areas = np.asarray(rec["gt_areas"], np.float64).reshape(-1)
        if len(gt_boxes) == 0 or len(boxes) == 0:
            continue
        valid = (gt_areas >= area_range[0]) & (gt_areas <= area_range[1])
        gt_boxes = gt_boxes[valid]
        num_pos += len(gt_boxes)
        if len(gt_boxes) == 0:
            continue
        if limit is not None and len(boxes) > limit:
            boxes = boxes[:limit]

        overlaps = _pairwise_iou_xyxy(boxes, gt_boxes)
        _gt_overlaps = np.zeros(len(gt_boxes))
        for j in range(min(len(boxes), len(gt_boxes))):
            max_overlaps = overlaps.max(axis=0)
            argmax_overlaps = overlaps.argmax(axis=0)
            gt_ind = int(max_overlaps.argmax())
            gt_ovr = max_overlaps[gt_ind]
            assert gt_ovr >= 0
            box_ind = int(argmax_overlaps[gt_ind])
            _gt_overlaps[j] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        gt_overlaps.append(_gt_overlaps)

    gt_overlaps = (
        np.sort(np.concatenate(gt_overlaps))
        if gt_overlaps else np.zeros(0, np.float64)
    )
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    thresholds = np.asarray(thresholds, np.float64)
    recalls = np.array(
        [(gt_overlaps >= t).sum() / float(max(num_pos, 1)) for t in thresholds]
    )
    return {
        "ar": float(recalls.mean()),
        "recalls": recalls,
        "thresholds": thresholds,
        "gt_overlaps": gt_overlaps,
        "num_pos": num_pos,
    }


def proposal_metrics(records: List[Dict]) -> Dict[str, float]:
    """The reference's table: AR{,s,m,l}@{100,1000} x100
    (coco_evaluation.py:290-299)."""
    res = {}
    for limit in (100, 1000):
        for area, suffix in (
            ("all", ""), ("small", "s"), ("medium", "m"), ("large", "l")
        ):
            stats = evaluate_box_proposals(records, area=area, limit=limit)
            res[f"AR{suffix}@{limit}"] = stats["ar"] * 100.0
    return res
