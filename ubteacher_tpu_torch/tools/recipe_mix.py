"""Recipe-mix throughput: the jitter-weighted effective img/s (port of the
JAX package's tools/recipe_mix.py).

The coco-standard recipes jitter the shortest edge over (400, 1200)
("range" sampling), and the loader puts each draw on the smallest canvas
of its orientation that holds it: 768x1344 (1344x768) or the 1024x1344
(1344x1024) scale bucket (TPU.EXTRA_TRAIN_CANVASES;
data/augment.py:weak_augment_geometry). A step timed at the base canvas
alone is not what the recipe trains at: the recipe's rate is the mix of the
per-canvas step times weighted by each bucket's probability.

The probabilities come from replaying the loader's own geometry code over
the COCO train2017 image sizes: the annotation file under $COCO_ROOT when
it is there, else the marginal approximation of tools/bench_loader.py
(COCO_LIKE_DIMS). A portrait canvas is the transpose of a landscape one and
folds onto it. Pure host arithmetic: no device.

Usage:
    python -m ubteacher_tpu_torch.tools.recipe_mix                      # probabilities only
    python -m ubteacher_tpu_torch.tools.recipe_mix --ms 768 1344 250.0 --ms 1024 1344 330.0
        # + the weighted effective img/s (16 images a step at 8 + 8)
"""

from __future__ import annotations

import argparse
import collections
import json
import os

import numpy as np

from .bench_loader import COCO_LIKE_DIMS
from .common import FCOS_CFG, load_cfg


def coco_dims(n: int, rng) -> list:
    """n (h, w) samples: the sizes of COCO val2017/train2017 images when the
    annotation file is under $COCO_ROOT, else COCO_LIKE_DIMS."""
    root = os.environ.get("COCO_ROOT", "datasets/coco")
    for name in ("instances_train2017.json", "instances_val2017.json"):
        p = os.path.join(root, "annotations", name)
        if os.path.isfile(p):
            with open(p) as f:
                images = json.load(f)["images"]
            idx = rng.integers(0, len(images), n)
            return [(images[i]["height"], images[i]["width"]) for i in idx]
    idx = rng.integers(0, len(COCO_LIKE_DIMS), n)
    return [COCO_LIKE_DIMS[i] for i in idx]


def bucket_probs(n: int = 20000, seed: int = 0) -> dict:
    """{"HxW" (short side first): the share of n draws whose canvas it is},
    from weak_augment_geometry's canvas choice over the size distribution."""
    from ..data.augment import weak_augment_geometry

    cfg = load_cfg((), FCOS_CFG)
    canvases = {
        "landscape": [tuple(cfg.TPU.CANVAS_LANDSCAPE)],
        "portrait": [tuple(cfg.TPU.CANVAS_PORTRAIT)],
    }
    for c in cfg.TPU.EXTRA_TRAIN_CANVASES:
        h, w = int(c[0]), int(c[1])
        canvases["landscape" if w >= h else "portrait"].append((h, w))

    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for h, w in coco_dims(n, rng):
        orient = "landscape" if w >= h else "portrait"
        g = weak_augment_geometry(
            h, w, np.zeros((0, 4), np.float32), canvases[orient],
            cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN,
            cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING, rng,
        )
        # orientation is a transpose of the same shape: fold it
        ch, cw = g["canvas"]
        counts[(min(ch, cw), max(ch, cw))] += 1
    return {f"{a}x{b}": c / n for (a, b), c in sorted(counts.items())}


def mix(probs: dict, ms: dict, imgs_per_step: float = 16.0) -> dict:
    """The JAX tool's record: the probabilities (4 places), and with a
    measured ms a step for every bucket ({"HxW": ms}), the weighted ms a
    step and img/s; else the buckets that lack one."""
    out = {"bucket_probs": {k: round(v, 4) for k, v in probs.items()}}
    if ms:
        missing = [k for k in probs if k not in ms]
        if missing:
            out["missing_ms_for"] = missing
        else:
            eff_ms = sum(probs[k] * ms[k] for k in probs)
            out["per_canvas_ms"] = ms
            out["effective_ms_per_step"] = round(eff_ms, 1)
            out["effective_img_s_chip"] = round(imgs_per_step / eff_ms * 1000.0, 1)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--ms", nargs=3, action="append", default=[], metavar=("H", "W", "MS"),
                    help="measured ms a step at canvas HxW (repeatable)")
    ap.add_argument("--imgs-per-step", type=float, default=16.0)
    args = ap.parse_args(argv)

    ms = {}
    for h, w, v in args.ms:
        a, b = sorted((int(h), int(w)))
        ms[f"{a}x{b}"] = float(v)
    out = mix(bucket_probs(args.n), ms, args.imgs_per_step)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
