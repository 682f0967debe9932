"""The R-CNN configuration's FLOP table, in harness/flops.py's format (read
by `flops.mutual_flops`): the convolutions and matrix products of an
iteration, counted as 2 x multiply-accumulate by torch's FlopCounterMode
over the frozen plain reference's R-CNN (reference/ubtref) on the meta
device. The frozen stem and res2 (FREEZE_AT 2) take no weight gradient and
pass none back.

Per image and canvas: `inference` (the backbone, FPN and RPN head, and the
box head on POST_NMS_TOPK_TEST proposals, no gradient: the teacher) and
`train` (the same forward with the box head on BATCH_SIZE_PER_IMAGE
sampled rois, and its backward, the gradient reaching the pooled features
as it reaches the pyramid through ROIAlign). ROIAlign, the RPN's ranking,
the matchers and the losses are gathers, sorts and elementwise work, not
products, and count 0 (as in the port's `tools/mfu.py`). An iteration:
  R-CNN mutual (l, u): B_u inference(u) [teacher] + 2 B_l train(l) + B_u train(u)
  R-CNN burn-in (l):   2 B_l train(l)

Regenerate the table (it is kept as data under flops/):
    python -m benchmark.harness.rcnn_flops --config rcnn_r50_fpn_coco_sup1
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from . import manifest
from .flops import _count, canvases, key, reference_cfg


def _meta_model(cfg):
    from ..reference.ubtref.modeling.rcnn import build_two_stage_rcnn
    from ..reference.ubtref.solver.build import freeze_parameters

    with torch.device("meta"):
        model = build_two_stage_rcnn(cfg, "meta", torch.Generator())
    freeze_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    return model


def per_image(model, cfg, canvas, train: bool) -> int:
    """FLOPs of one image at `canvas`, forward only (test-time proposals)
    or forward and backward (the sampled rois)."""
    h, w = canvas
    p = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    rois = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE if train else cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    images = torch.zeros((1, h, w, 3), device="meta")

    def run():
        with torch.set_grad_enabled(train):
            pyramid = model.features(images)
            logits, deltas = model.rpn(pyramid)
            pooled = torch.zeros((rois, p, p, cfg.MODEL.FPN.OUT_CHANNELS), device="meta", requires_grad=train)
            outs = model.box_predictor(model.box_head(pooled))
            if train:
                sum(t.float().sum() for t in (logits, deltas, *outs)).backward()

    return _count(run)


def table(config_name: str, extra=None) -> Dict:
    """The FLOP table of an R-CNN configuration (`extra`: cfg keys over the
    file's, for a test at a small size)."""
    conf = manifest.config(config_name)
    cfg = reference_cfg(conf, extra)
    model = _meta_model(cfg)
    train_c = canvases(cfg)
    th, tw = cfg.TPU.TEST_CANVAS
    test_c = [(min(th, tw), max(th, tw)), (max(th, tw), min(th, tw))]
    per = {}
    for c in train_c:
        per[key(c)] = {"inference": per_image(model, cfg, c, False), "train": per_image(model, cfg, c, True)}
    for c in test_c:
        per.setdefault(key(c), {})["inference"] = per_image(model, cfg, c, False)
    bl, bu = cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.IMG_PER_BATCH_UNLABEL
    return {
        "config": config_name,
        "batch_label": bl,
        "batch_unlabel": bu,
        "per_image": per,
        "burnin": {key(l): 2 * bl * per[key(l)]["train"] for l in train_c},
        "mutual": {f"{key(l)}|{key(u)}": bu * per[key(u)]["inference"] + 2 * bl * per[key(l)]["train"]
                   + bu * per[key(u)]["train"] for l in train_c for u in train_c},
        "test": {key(c): per[key(c)]["inference"] for c in test_c},
        "command": f"python -m benchmark.harness.rcnn_flops --config {config_name}",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="regenerate an R-CNN FLOP table under benchmark/flops/")
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    out = os.path.join(manifest.BENCH_DIR, "flops", f"{args.config}.json")
    with open(out, "w") as f:
        json.dump(table(args.config), f, indent=1)
        f.write("\n")
    print(out)


if __name__ == "__main__":
    main()
