"""Inference over a test set: batched inference on the model's device -> host
COCO evaluation (PyTorch port of ubteacher_tpu.evaluation.evaluator).

Equivalent of inference_on_dataset (reference:
ubteacher/evaluation/evaluator.py:14-118): per-batch forward and decode,
warm-up-aware timing, detections rescaled to original image coordinates and
fed to the numpy COCO evaluator. The nms_method (NMS_CRITERIA_TEST) kwarg is
an FCOS-only feature, matching the reference.

Single process only: the JAX evaluator gathers every host's detection rows
(parallel.allgather_host_rows) so that each host scores the whole test set;
the port's counterpart waits for data parallelism (ROADMAP Queue A item 11).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..modeling.fcos_outputs import (
    compute_locations,
    fcos_decode,
    fcos_loss_config,
    level_feature_sizes,
)
from .coco_eval import COCOBboxEvaluator


def make_fcos_inference_fn(cfg, nms_method: str | None = None, train: bool = False) -> Callable:
    """Returns infer(model, images (B, H, W, 3), hw (B, 2)) -> Detections at
    the test thresholds (INFERENCE_TH_TEST, *_TOPK_TEST), or with `train` at
    the train-time ones the teacher's pseudo-label decode uses (the training
    visualization's); NMS criterion `nms_method` or NMS_CRITERIA_TEST. The
    model runs under the bf16 autocast of the train steps when
    TPU.COMPUTE_DTYPE is "bfloat16"."""
    fcfg = fcos_loss_config(cfg)
    strides = list(cfg.MODEL.FCOS.FPN_STRIDES)
    f = cfg.MODEL.FCOS
    method = nms_method or f.NMS_CRITERIA_TEST
    bf16 = cfg.TPU.COMPUTE_DTYPE == "bfloat16"

    @torch.inference_mode()
    def infer(model, images: torch.Tensor, hw: torch.Tensor):
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=bf16):
            dense = model(images, hw)
        h, w = images.shape[1:3]
        grid = compute_locations((h, w), strides, images.device)
        lengths = [fh * fw for fh, fw in level_feature_sizes((h, w), strides)]
        return fcos_decode(
            dense, grid, lengths, hw, fcfg,
            nms_method=method,
            pre_nms_thresh=f.INFERENCE_TH_TRAIN if train else f.INFERENCE_TH_TEST,
            pre_nms_topk=f.PRE_NMS_TOPK_TRAIN if train else f.PRE_NMS_TOPK_TEST,
            post_nms_topk=f.POST_NMS_TOPK_TRAIN if train else f.POST_NMS_TOPK_TEST,
            nms_thresh=f.NMS_TH,
            total_candidates=cfg.TPU.NMS_CANDIDATES,
        )

    return infer


def inference_on_dataset(
    cfg,
    model: torch.nn.Module,
    data_loader,
    dataset_dicts: List[Dict],
    nms_method: str | None = None,
    num_classes: int | None = None,
    infer_fn: Callable | None = None,
    proposal_fn: Callable | None = None,
) -> Dict[str, float]:
    """Runs inference over the test loader and computes COCO bbox AP.

    `model` is the teacher or student module; batches go to the device of
    its parameters. dataset_dicts supply the ground truth (already
    contiguous category ids, xyxy boxes). infer_fn overrides the default
    FCOS inference (the R-CNN path passes make_rcnn_inference_fn(cfg)).
    proposal_fn, when given ((model, images, hw) -> (boxes, objectness,
    mask), engine.rcnn_trainer.make_rcnn_proposal_fn), additionally reports
    box-proposal AR{,s,m,l}@{100,1000} like the reference's box_proposals
    task (coco_evaluation.py:258-301).
    """
    num_classes = num_classes or cfg.MODEL.FCOS.NUM_CLASSES
    by_id = {d["image_id"]: d for d in dataset_dicts}
    infer = infer_fn or make_fcos_inference_fn(cfg, nms_method)

    det_rows, prop_rows, total_time, n_images = collect_detections(
        model, data_loader, by_id, infer, proposal_fn
    )
    results = evaluate_detection_rows(
        det_rows, dataset_dicts, num_classes,
        prop_rows if proposal_fn is not None else None,
    )
    if n_images > 0:
        results["inference_sec_per_image"] = total_time / n_images
    return results


def _host(value):
    """Detections (or a tuple of tensors) -> numpy on the host; the copy
    waits for the device."""
    if isinstance(value, tuple):
        return tuple(t.cpu().numpy() for t in value)
    return type(value)(**{k: v.cpu().numpy() for k, v in vars(value).items()})


def collect_detections(
    model: torch.nn.Module, data_loader, by_id: Dict, infer: Callable,
    proposal_fn: Callable | None = None,
):
    """Run inference over `data_loader`, returning fixed-width numpy rows:
    detections (N, 7) [img_id, x, y, w, h, score, cls] in ORIGINAL image
    coordinates, proposals (M, 6) [img_id, x1, y1, x2, y2, objectness],
    plus (timed_seconds, timed_images) for warm-up-aware latency: the first
    5 batches and the first batch of each canvas are not timed, and the
    timed span runs from the call to the detections on the host."""
    device = next(model.parameters()).device
    num_warmup = 5
    total_time = 0.0
    n_images = 0
    det_rows: List[np.ndarray] = []
    prop_rows: List[np.ndarray] = []
    seen_canvases = set()
    with torch.inference_mode():
        for i, batch in enumerate(data_loader):
            canvas = tuple(batch["images"].shape[1:3])
            first_of_canvas = canvas not in seen_canvases
            seen_canvases.add(canvas)
            imgs_d = torch.as_tensor(batch["images"]).to(device, torch.float32)
            hw_d = torch.as_tensor(batch["hw"]).to(device, torch.float32)
            t0 = time.perf_counter()
            dets = _host(infer(model, imgs_d, hw_d))
            dt = time.perf_counter() - t0
            if i >= num_warmup and not first_of_canvas:
                total_time += dt
                n_images += batch["num_valid"]
            if proposal_fn is not None:
                # a second backbone + RPN forward: EVAL_PROPOSALS is an
                # optional diagnostic (the reference gates it the same way)
                pboxes, pscores, pmask = _host(proposal_fn(model, imgs_d, hw_d))
            scales = np.asarray(batch["scales"], np.float32)
            for bi in range(batch["num_valid"]):
                img_id = batch["image_ids"][bi]
                scale = scales[bi]
                mask = dets.mask[bi]
                boxes = dets.boxes[bi][mask] / scale  # back to original pixels
                # clip to original size
                d = by_id[img_id]
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, d["width"])
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, d["height"])
                xywh = boxes.astype(np.float64)
                xywh[:, 2:] -= xywh[:, :2]
                rows = np.empty((len(xywh), 7), np.float64)
                rows[:, 0] = img_id
                rows[:, 1:5] = xywh
                rows[:, 5] = dets.scores[bi][mask]
                rows[:, 6] = dets.classes[bi][mask]
                det_rows.append(rows)
                if proposal_fn is not None:
                    pb = (pboxes[bi][pmask[bi]] / scale).astype(np.float64)
                    pb[:, 0::2] = pb[:, 0::2].clip(0, d["width"])
                    pb[:, 1::2] = pb[:, 1::2].clip(0, d["height"])
                    prows = np.empty((len(pb), 6), np.float64)
                    prows[:, 0] = img_id
                    prows[:, 1:5] = pb
                    prows[:, 5] = pscores[bi][pmask[bi]]
                    prop_rows.append(prows)

    det = (
        np.concatenate(det_rows) if det_rows else np.zeros((0, 7), np.float64)
    )
    prop = (
        np.concatenate(prop_rows)
        if prop_rows else np.zeros((0, 6), np.float64)
    )
    return det, prop, total_time, n_images


def evaluate_detection_rows(
    det_rows: np.ndarray,
    dataset_dicts: List[Dict],
    num_classes: int,
    prop_rows: np.ndarray | None = None,
) -> Dict[str, float]:
    """Score detection rows (collect_detections format) against the FULL
    dataset's ground truth. Pure host-side."""
    evaluator = COCOBboxEvaluator(num_classes)
    for d in dataset_dicts:
        boxes_xyxy = np.asarray(
            [o["bbox"] for o in d["annotations"]], np.float64
        ).reshape(-1, 4)
        xywh = boxes_xyxy.copy()
        xywh[:, 2:] -= xywh[:, :2]
        evaluator.add_ground_truth(
            d["image_id"],
            xywh,
            [o["category_id"] for o in d["annotations"]],
            iscrowd=[o.get("iscrowd", 0) for o in d["annotations"]],
            areas=[o.get("area", None) or (b[2] * b[3]) for o, b in zip(d["annotations"], xywh)],
        )
    det_rows = np.asarray(det_rows, np.float64).reshape(-1, 7)
    for img_id in np.unique(det_rows[:, 0]):
        r = det_rows[det_rows[:, 0] == img_id]
        evaluator.add_detections(
            int(img_id), r[:, 1:5], r[:, 5], r[:, 6].astype(np.int64)
        )
    results = evaluator.evaluate()

    if prop_rows is not None:
        from .proposal_eval import proposal_metrics

        by_id = {d["image_id"]: d for d in dataset_dicts}
        prop_rows = np.asarray(prop_rows, np.float64).reshape(-1, 6)
        records = []
        for img_id in np.unique(prop_rows[:, 0]):
            r = prop_rows[prop_rows[:, 0] == img_id]
            d = by_id[int(img_id)]
            anns = [o for o in d["annotations"] if not o.get("iscrowd", 0)]
            records.append({
                "proposal_boxes": r[:, 1:5],
                "objectness": r[:, 5],
                "gt_boxes": np.asarray(
                    [o["bbox"] for o in anns], np.float64
                ).reshape(-1, 4),
                "gt_areas": [
                    o.get("area", None)
                    or (o["bbox"][2] - o["bbox"][0])
                    * (o["bbox"][3] - o["bbox"][1])
                    for o in anns
                ],
            })
        results.update(proposal_metrics(records))
    return results
