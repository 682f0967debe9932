"""One-command COCO AP of a reference checkpoint through the port.

Given a COCO root and a reference unbiased-teacher-v2 .pth (an
EnsembleTSModel state dict, torch-saved), this runs
  convert (teacher by default) -> the port's inference -> COCO AP table,
so the "mAP within 0.5 of the reference" check is one invocation once real
data and checkpoints are at hand. The reference's flow: train_net.py
--eval-only evaluates the TEACHER of the ensemble checkpoint (reference:
train_net.py:37-51, detection_checkpoint.py:10-89). Runs on the first card
unless --cpu is given.

    python -m ubteacher_tpu_torch.tools.parity_eval --checkpoint model.pth \\
        [--config configs/FCOS/coco-standard/fcos_R_50_ut2_sup1_run0.yaml] \\
        [--coco-root $COCO_ROOT] [--model student|teacher] [--split val2017] \\
        [--limit N] [--eval-batch 8] [--cpu] [KEY VALUE ...]

Checkpoints: torch .pth/.pt (loaded on the CPU) or pickle .pkl, holding
{"model": state_dict} or a bare state dict; keys of an EnsembleTSModel
("modelTeacher.*" / "modelStudent.*", DDP "module." stripped) or of a bare
detector. Images are read with cv2 (`data/loader.py:default_image_loader`).
"""

from __future__ import annotations

import argparse
import os

import torch

from .common import FCOS_CFG, load_cfg, tool_device, triton_cache_in_checkout

SUMMARY = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", default=FCOS_CFG)
    ap.add_argument("--coco-root", default=os.environ.get("COCO_ROOT", ""))
    ap.add_argument("--model", choices=("teacher", "student"), default="teacher")
    ap.add_argument("--split", default="val2017")
    ap.add_argument("--limit", type=int, default=0, help="evaluate only the first N images")
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the first card)")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="'KEY VALUE' config overrides")
    return ap


def load_detector(cfg, checkpoint: str, which: str, device):
    """The detector of `cfg` on `device` with the `which` (teacher or
    student) weights of a reference checkpoint (or its bare state dict)."""
    from ..checkpoint.torch_weights import (
        cast_like,
        convert_ubt_fcos_model,
        convert_ubt_rcnn_model,
        load_torch_state_dict,
        split_ensemble_state,
    )

    sd = load_torch_state_dict(checkpoint)
    parts = split_ensemble_state(sd)
    if parts["teacher"] or parts["student"]:
        sd = parts[which]
        if not sd:
            raise SystemExit(f"checkpoint has no {which} weights (found: {[k for k, v in parts.items() if v]})")
        print(f"using {which} weights from the ensemble checkpoint")
    else:
        print("checkpoint is a bare detector state dict")
    depth = cfg.MODEL.RESNETS.DEPTH
    if cfg.SEMISUPNET.Trainer == "ubteacher_rcnn":
        from ..modeling.rcnn import build_two_stage_rcnn

        model = build_two_stage_rcnn(cfg, device, torch.Generator().manual_seed(0))
        converted = convert_ubt_rcnn_model(sd, depth, cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
    else:
        from ..modeling.fcos_head import build_one_stage_detector

        model = build_one_stage_detector(cfg, device, torch.Generator().manual_seed(0))
        converted = convert_ubt_fcos_model(sd, depth)
    # every parameter of the port's module must come from the checkpoint
    model.load_state_dict(cast_like(converted, model.state_dict()))
    return model


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..data.coco import load_coco_json
    from ..data.loader import TestDataLoader
    from ..evaluation import inference_on_dataset

    device = tool_device(args.cpu)
    cfg = load_cfg(args.opts, args.config)
    model = load_detector(cfg, args.checkpoint, args.model, device)
    rcnn = cfg.SEMISUPNET.Trainer == "ubteacher_rcnn"
    infer_fn = proposal_fn = None  # the evaluator builds the FCOS one (its NMS criteria)
    num_classes = cfg.MODEL.FCOS.NUM_CLASSES
    if rcnn:
        from ..engine.rcnn_trainer import make_rcnn_inference_fn, make_rcnn_proposal_fn

        infer_fn = make_rcnn_inference_fn(cfg)
        proposal_fn = make_rcnn_proposal_fn(cfg) if cfg.TEST.EVAL_PROPOSALS else None
        num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES

    root = args.coco_root or "datasets/coco"
    ann = os.path.join(root, f"annotations/instances_{args.split}.json")
    dicts, _ = load_coco_json(ann, os.path.join(root, args.split))
    if args.limit:
        dicts = dicts[: args.limit]
    print(f"evaluating {len(dicts)} images from {ann} on {device}")

    loader = TestDataLoader(cfg, dicts, batch_size=args.eval_batch)
    results = inference_on_dataset(cfg, model, loader, dicts, nms_method=cfg.MODEL.FCOS.NMS_CRITERIA_TEST,
                                   num_classes=num_classes, infer_fn=infer_fn, proposal_fn=proposal_fn)
    print("\n== COCO bbox AP ==")
    for k in SUMMARY:
        print(f"  {k:6s} {results.get(k, float('nan')):7.3f}")
    if "inference_sec_per_image" in results:
        print(f"  sec/img {results['inference_sec_per_image']:.4f}")
    return results


if __name__ == "__main__":
    triton_cache_in_checkout()
    main()
