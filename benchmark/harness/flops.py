"""FLOP tables: the convolutions and matrix products of an iteration,
counted as 2 x multiply-accumulate by torch's FlopCounterMode over the
benchmark's frozen plain reference, on the meta device (shapes only, no
arithmetic). Forward and backward are counted as training runs them: the
frozen stem and res2 (FREEZE_AT 2) take no weight gradient and pass none
back to the image, and nothing is recomputed. The count reads the work the
recipe asks for, whatever implements it, so a change to the port cannot move
it.

Per image and canvas: `inference` (one forward, no gradient) and `train`
(forward and backward). An iteration's count combines them as the steps do:
  FCOS mutual (l, u):  B_u inference(u) [teacher] + 2 B_l train(l) + B_u train(u)
  FCOS burn-in (l):    2 B_l train(l)

Regenerate a table (it is kept as data under flops/):
    python -m benchmark.harness.flops --config fcos_r50_coco_sup1
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence, Tuple

import torch

from . import cfgs, manifest


def reference_cfg(conf: Dict, extra=None):
    from ..reference.ubtref import config as ref_config

    return cfgs.build(ref_config, conf["cfg"], dict({"TPU.COMPUTE_DTYPE": "float32"}, **(extra or {})))


def _meta_model(cfg):
    from ..reference.ubtref.modeling.fcos_head import build_one_stage_detector
    from ..reference.ubtref.solver.build import freeze_parameters

    with torch.device("meta"):
        model = build_one_stage_detector(cfg, "meta", torch.Generator())
    freeze_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    return model


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for f in x.__dataclass_fields__:
            yield from _tensors(getattr(x, f))


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def per_image(model, canvas: Tuple[int, int], train: bool) -> int:
    """FLOPs of one image at `canvas`, forward only or forward and backward."""
    h, w = canvas
    images = torch.zeros((1, h, w, 3), device="meta")

    def run():
        with torch.set_grad_enabled(train):
            outs = [model(images)]
            if train:
                sum(t.float().sum() for t in _tensors(outs) if t.requires_grad).backward()

    return _count(run)


def canvases(cfg) -> Sequence[Tuple[int, int]]:
    """The train canvases (each orientation's base and its extra buckets)."""
    out = [tuple(cfg.TPU.CANVAS_LANDSCAPE), tuple(cfg.TPU.CANVAS_PORTRAIT)]
    out += [tuple(int(v) for v in c) for c in cfg.TPU.EXTRA_TRAIN_CANVASES]
    return out


def key(canvas) -> str:
    return f"{canvas[0]}x{canvas[1]}"


def mutual_flops(table_: Dict, pair) -> int:
    """A mutual iteration's count at its (labeled, unlabeled) canvas pair."""
    return table_["mutual"][f"{key(pair[0])}|{key(pair[1])}"]


def table(config_name: str, extra=None) -> Dict:
    """The FLOP table of a configuration (`extra`: cfg keys over the file's,
    for a test at a small size)."""
    conf = manifest.config(config_name)
    cfg = reference_cfg(conf, extra)
    model = _meta_model(cfg)
    train_c = canvases(cfg)
    th, tw = cfg.TPU.TEST_CANVAS
    test_c = [(min(th, tw), max(th, tw)), (max(th, tw), min(th, tw))]
    per = {}
    for c in train_c:
        per[key(c)] = {"inference": per_image(model, c, False), "train": per_image(model, c, True)}
    for c in test_c:
        per.setdefault(key(c), {})["inference"] = per_image(model, c, False)
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
        "command": f"python -m benchmark.harness.flops --config {config_name}",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="regenerate a FLOP table under benchmark/flops/")
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    out = os.path.join(manifest.BENCH_DIR, "flops", f"{args.config}.json")
    with open(out, "w") as f:
        json.dump(table(args.config), f, indent=1)
        f.write("\n")
    print(out)


if __name__ == "__main__":
    main()
