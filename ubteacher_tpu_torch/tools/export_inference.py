"""Export the inference path for serving (torch.export), the port of the JAX
package's tools/export_inference.py (jax.export / StableHLO).

The program is the detector's inference function (FCOS:
evaluation/evaluator.py:make_fcos_inference_fn; Faster R-CNN:
engine/rcnn_trainer.py:make_rcnn_inference_fn) of
(params, images (B, H, W, 3) float32, hw (B, 2) float32) -> the Detections'
fields as a dict of tensors, written with torch.export.save. As in the JAX
tool the parameters are an input of the program: the model's state_dict as
the port's checkpoints hold it (a checkpoint's "teacher" or "student"; a
reference detectron2 checkpoint converts to it through
checkpoint/torch_weights.py). The model is built on the meta device for
its shapes only, and its parameters are swapped in with
torch.func.functional_call. The hand-written kernels on the path (NMS, the
ROIAlign forward, the fused stem under TPU.STEM_MODE "pallas") are
torch.library ops (`ubt::*`), traced as calls. So a serving process needs
torch and this package's ops, and no config and no model-building code:

    import torch
    import ubteacher_tpu_torch.ops  # registers the ubt:: ops
    program = torch.export.load(path).module()
    dets = program(dict(state_dict), images, hw)  # {"boxes": (B, K, 4), "scores": ..., "mask": ...}

The program is traced for one device (the card unless --cpu) and one batch
and canvas, as the JAX artifact is lowered for one platform and shape. A
JSON file beside it holds the JAX tool's metadata (`detector`, `batch`,
`canvas`, `bytes`), with `device` in place of `platforms`.

Usage:
  python -m ubteacher_tpu_torch.tools.export_inference --out fcos_infer.pt2 [--rcnn]
      [--batch 1] [--canvas 800 1344] [--config CFG] [--cpu] [--opts KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict

import torch
from torch import nn

from .common import FCOS_CFG, RCNN_CFG, device_label, load_cfg, tool_device


class _Bound(nn.Module):
    """A detector and its inference function as one module."""

    def __init__(self, model: nn.Module, infer: Callable):
        super().__init__()
        self.model = model
        self.infer = infer

    def forward(self, images, hw):
        return self.infer(self.model, images, hw)


class InferenceProgram(nn.Module):
    """forward(params, images, hw) -> {Detections field: tensor}: the bound
    detector run on `params` (its state_dict names). The detector is held
    outside the module tree, so its own (meta) tensors are no input of the
    trace."""

    def __init__(self, model: nn.Module, infer: Callable):
        super().__init__()
        object.__setattr__(self, "_bound", _Bound(model, infer))

    def forward(self, params: Dict[str, torch.Tensor], images: torch.Tensor, hw: torch.Tensor):
        dets = torch.func.functional_call(self._bound, {f"model.{k}": v for k, v in params.items()},
                                          (images, hw))
        return dict(vars(dets))


def inference_fn(cfg, rcnn: bool) -> Callable:
    """The detector's inference function, (model, images, hw) ->
    Detections, without the inference_mode decorator (a trace runs under
    no_grad)."""
    if rcnn:
        from ..engine.rcnn_trainer import make_rcnn_inference_fn

        return make_rcnn_inference_fn(cfg)
    from ..evaluation.evaluator import make_fcos_inference_fn

    infer = make_fcos_inference_fn(cfg)
    return getattr(infer, "__wrapped__", infer)


def build_model(cfg, rcnn: bool, device) -> nn.Module:
    """The detector on `device`, in eval mode."""
    if rcnn:
        from ..modeling.rcnn import build_two_stage_rcnn as build
    else:
        from ..modeling.fcos_head import build_one_stage_detector as build
    return build(cfg, device=device).eval()


def shape_model(cfg, rcnn: bool, device) -> nn.Module:
    """The detector built on the meta device (its parameters' shapes only),
    with its constants, the pixel normalization that is no part of the
    state_dict, on `device`."""
    model = build_model(cfg, rcnn, "meta")
    model.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=device)
    model.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32, device=device)
    kept = set(model.state_dict())
    left = [n for n, b in model.named_buffers() if n not in kept and b.is_meta]
    if left:
        raise RuntimeError(f"buffers outside the state_dict with no value: {left}")
    return model


def export_program(cfg, rcnn: bool, batch: int, canvas, device) -> torch.export.ExportedProgram:
    """Trace the inference function for `batch` images on `canvas` on
    `device`."""
    model = shape_model(cfg, rcnn, device)
    params = {k: torch.empty_like(v, device=device) for k, v in model.state_dict().items()}
    h, w = canvas
    images = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device)
    hw = torch.full((batch, 2), 1.0, device=device) * torch.tensor([float(h), float(w)], device=device)
    program = InferenceProgram(model, inference_fn(cfg, rcnn))
    with torch.no_grad():
        return torch.export.export(program, (params, images, hw))


def save(exported: torch.export.ExportedProgram, path: str) -> int:
    """Write the program without its example inputs (the traced parameters
    would double the file); -> its size in bytes."""
    exported.example_inputs = None
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load(path: str) -> Callable:
    """The saved program as a callable (params, images, hw) -> dict; params
    a state_dict (any mapping: the program takes a plain dict)."""
    program = torch.export.load(path).module()

    def call(params, images, hw):
        return program(dict(params), images, hw)

    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rcnn", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--canvas", type=int, nargs=2, default=(800, 1344))
    ap.add_argument("--config", default=FCOS_CFG)
    ap.add_argument("--cpu", action="store_true", help="trace for the CPU (default: the first card)")
    ap.add_argument("--opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    # only swap the untouched default config for --rcnn
    if args.rcnn and args.config == ap.get_default("config"):
        args.config = RCNN_CFG
    device = tool_device(args.cpu)
    cfg = load_cfg(args.opts, args.config)
    exported = export_program(cfg, args.rcnn, args.batch, tuple(args.canvas), device)
    meta = {
        "detector": "rcnn" if args.rcnn else "fcos",
        "batch": args.batch,
        "canvas": list(args.canvas),
        "device": device_label(device),
        "bytes": save(exported, args.out),
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
