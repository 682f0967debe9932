"""COCO-style bbox AP evaluation, pure numpy (the port's copy of
ubteacher_tpu.evaluation.coco_eval).

Replacement for the reference's COCOEvaluator + pycocotools COCOeval
(reference: ubteacher/evaluation/coco_evaluation.py:29-609; pycocotools is
not available in this environment). Implements the standard COCO protocol:
greedy score-ordered matching per (category, IoU threshold, area range),
crowd handling, 101-point interpolated precision, AP/AP50/AP75/APs/APm/APl
and AR@[1,10,100] + per-area AR.

A host-side metric: the C++ matcher of csrc/coco_eval_native.cpp, built
with g++ by evaluation/native.py, or the numpy route beside it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU with pycocotools semantics: for crowd gt, IoU = inter / det_area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None])
    iy1 = np.maximum(dy1[:, None], gy1[None])
    ix2 = np.minimum(dx2[:, None], gx2[None])
    iy2 = np.minimum(dy2[:, None], gy2[None])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOBboxEvaluator:
    """Accumulates detections + ground truth, then computes COCO AP.

    Ground truth boxes are xywh absolute pixels with `category_id` already
    contiguous [0, C); detections likewise (convert before feeding).
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        # per (image, cat): lists
        self._gt = defaultdict(list)
        self._dt = defaultdict(list)
        self._img_ids = set()

    def add_ground_truth(
        self, image_id, boxes_xywh: np.ndarray, classes: Sequence[int],
        iscrowd: Sequence[int] | None = None, areas: Sequence[float] | None = None,
    ):
        self._img_ids.add(image_id)
        iscrowd = iscrowd if iscrowd is not None else [0] * len(classes)
        for i, (b, c) in enumerate(zip(boxes_xywh, classes)):
            area = areas[i] if areas is not None else float(b[2] * b[3])
            self._gt[(image_id, int(c))].append(
                {"bbox": np.asarray(b, np.float64), "iscrowd": int(iscrowd[i]),
                 "area": area}
            )

    def add_detections(
        self, image_id, boxes_xywh: np.ndarray, scores: Sequence[float],
        classes: Sequence[int],
    ):
        self._img_ids.add(image_id)
        for b, s, c in zip(boxes_xywh, scores, classes):
            self._dt[(image_id, int(c))].append(
                {"bbox": np.asarray(b, np.float64), "score": float(s)}
            )

    # -- matching ----------------------------------------------------------
    def _evaluate_img(self, img_id, cat, area_rng, max_det):
        """Greedy matching for one (image, category, area-range). Uses the
        C++ matcher (csrc/coco_eval_native.cpp) when available; sorted
        detection views are cached per (img, cat) across area ranges."""
        gts = self._gt.get((img_id, cat), [])
        dts = self._dt.get((img_id, cat), [])
        if len(gts) == 0 and len(dts) == 0:
            return None

        if not hasattr(self, "_sorted_cache"):
            self._sorted_cache = {}
        key = (img_id, cat)
        cached = self._sorted_cache.get(key)
        if cached is None:
            d_order = np.argsort(
                [-d["score"] for d in dts], kind="stable"
            )
            dts_sorted = [dts[i] for i in d_order]
            d_boxes = np.asarray(
                [d["bbox"] for d in dts_sorted]
            ).reshape(-1, 4)
            d_scores = np.asarray([d["score"] for d in dts_sorted])
            cached = {"dts": dts_sorted, "d_boxes": d_boxes,
                      "d_scores": d_scores}
            self._sorted_cache[key] = cached

        dts_sorted = cached["dts"][:max_det]
        d_boxes = cached["d_boxes"][:max_det]
        d_scores = cached["d_scores"][:max_det]

        g_ignore = np.array(
            [
                g["iscrowd"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]
                for g in gts
            ],
            bool,
        )
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        g_boxes = np.asarray([g["bbox"] for g in gts]).reshape(-1, 4)
        iscrowd = np.asarray([g["iscrowd"] for g in gts], np.int32)

        from . import native

        ious = None
        if len(d_boxes) and len(g_boxes):
            ious = native.bbox_iou(d_boxes, g_boxes, iscrowd)
        if ious is None:
            ious = _iou_xywh(d_boxes, g_boxes, iscrowd)

        d_areas = d_boxes[:, 2] * d_boxes[:, 3] if len(d_boxes) else np.zeros(0)
        d_out = (d_areas < area_rng[0]) | (d_areas > area_rng[1])

        T = len(IOU_THRS)
        D, G = len(dts_sorted), len(gts)
        result = native.match_dets(
            IOU_THRS, ious.reshape(D, G), g_ignore, iscrowd.astype(np.uint8),
            d_out,
        ) if D else (np.zeros((T, 0), np.int64), np.zeros((T, 0), bool), None)
        if result is None:
            # numpy route (same algorithm as the C++ matcher)
            dt_match = np.zeros((T, D), np.int64)
            gt_match = np.zeros((T, G), np.int64)
            dt_ignore = np.zeros((T, D), bool)
            for t, thr in enumerate(IOU_THRS):
                for di in range(D):
                    best_iou = min(thr, 1 - 1e-10)
                    best_g = -1
                    for gi in range(G):
                        if gt_match[t, gi] > 0 and not iscrowd[gi]:
                            continue
                        if best_g > -1 and not g_ignore[best_g] and g_ignore[gi]:
                            break
                        if ious[di, gi] < best_iou:
                            continue
                        best_iou = ious[di, gi]
                        best_g = gi
                    if best_g == -1:
                        if d_out[di]:
                            dt_ignore[t, di] = True
                        continue
                    dt_ignore[t, di] = g_ignore[best_g]
                    dt_match[t, di] = best_g + 1
                    gt_match[t, best_g] = di + 1
        else:
            dt_match, dt_ignore = result[0], result[1]

        return {
            "dt_scores": d_scores,
            "dt_match": dt_match,
            "dt_ignore": dt_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    # -- accumulate + summarize -------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        img_ids = sorted(self._img_ids, key=lambda x: (str(type(x)), x))
        T = len(IOU_THRS)
        R = len(RECALL_THRS)
        K = self.num_classes
        A = len(AREA_RANGES)
        M = len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k in range(K):
            for a, (aname, arng) in enumerate(AREA_RANGES.items()):
                for m, max_det in enumerate(MAX_DETS):
                    evals = [
                        self._evaluate_img(img_id, k, arng, max_det)
                        for img_id in img_ids
                    ]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["dt_scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    matches = np.concatenate([e["dt_match"] for e in evals], 1)[
                        :, order
                    ]
                    ignores = np.concatenate([e["dt_ignore"] for e in evals], 1)[
                        :, order
                    ]
                    num_gt = sum(e["num_gt"] for e in evals)
                    if num_gt == 0:
                        continue
                    tps = (matches > 0) & ~ignores
                    fps = (matches == 0) & ~ignores
                    tp_cum = np.cumsum(tps, 1).astype(np.float64)
                    fp_cum = np.cumsum(fps, 1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_cum[t], fp_cum[t]
                        nd = len(tp)
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # precision envelope (monotone non-increasing)
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, RECALL_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q

        def _summarize(ap=True, iou_thr=None, area="all", max_det=100):
            a = list(AREA_RANGES).index(area)
            m = MAX_DETS.index(max_det)
            if ap:
                s = precision[:, :, :, a, m]
                if iou_thr is not None:
                    s = s[[np.where(np.isclose(IOU_THRS, iou_thr))[0][0]]]
            else:
                s = recall[:, :, a, m]
                if iou_thr is not None:
                    s = s[[np.where(np.isclose(IOU_THRS, iou_thr))[0][0]]]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else float("nan")

        results = {
            "AP": _summarize(True) * 100,
            "AP50": _summarize(True, iou_thr=0.5) * 100,
            "AP75": _summarize(True, iou_thr=0.75) * 100,
            "APs": _summarize(True, area="small") * 100,
            "APm": _summarize(True, area="medium") * 100,
            "APl": _summarize(True, area="large") * 100,
            "AR1": _summarize(False, max_det=1) * 100,
            "AR10": _summarize(False, max_det=10) * 100,
            "AR100": _summarize(False, max_det=100) * 100,
        }
        # per-category AP (reference: coco_evaluation.py derives a
        # per-category table from the precision tensor)
        a = list(AREA_RANGES).index("all")
        m = MAX_DETS.index(100)
        for k in range(K):
            s = precision[:, :, k, a, m]
            s = s[s > -1]
            results[f"AP-cat{k}"] = float(np.mean(s)) * 100 if s.size else float("nan")
        return results
