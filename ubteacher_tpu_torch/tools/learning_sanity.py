"""End-to-end learning check of the port: synthetic data -> AP.

Drives the port's whole trainer (two-stream loader, strong augmentation,
EMA teacher, dual-NMS pseudo-labels, eval) on a synthetic COCO set of
coloured rectangles and reports student and teacher AP after N steps. A
detector trained from scratch must reach a clear AP on this task; AP near 0
after training points at a wiring or semantics fault. Port of the JAX
package's tools/learning_sanity.py: the same data, the same config key for
key, the same JSON line, plus a "device" field (the card's name and power
limit, or "cpu"). Runs on the first card unless --cpu is given.

With --ablation, supervised-only against SSOD on one labeled set (the
recipe that tests/test_torch_fcos_lift.py pins: --steps 1000 --burnin 600):

    python -m ubteacher_tpu_torch.tools.learning_sanity --ablation \\
        --steps 1000 --burnin 600 [--rcnn] [--seed 0] [--cpu] [--opts KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .common import FCOS_CFG, RCNN_CFG, device_label, tool_device, triton_cache_in_checkout


def synthetic_coco(root: Path, n_images: int, size: int, seed: int = 0, color_jitter: int = 0):
    """COCO-format dataset of coloured rectangles on noise (3 classes):
    -> (json path, image dir, {file path: (size, size, 3) uint8}). The
    images stay in memory (read through the trainer's image_loader=).

    color_jitter > 0 adds per-instance uniform colour noise (+/-jitter per
    channel): a handful of labeled images then underdetermines each class's
    colour distribution, which is what gives unlabeled data room to help in
    the SSOD ablation."""
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    ann_id = 1
    img_dir = root / "images"
    img_dir.mkdir(exist_ok=True, parents=True)
    arrays = {}
    for i in range(n_images):
        fname = f"img{i}.png"
        img = rng.integers(0, 80, size=(size, size, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            w, h = int(rng.integers(20, 48)), int(rng.integers(20, 48))
            x = int(rng.integers(0, size - w))
            y = int(rng.integers(0, size - h))
            cat = int(rng.integers(1, 4))
            color = np.array([60 + 60 * cat, 40 * cat, 255 - 50 * cat], np.int64)
            if color_jitter:
                color = color + rng.integers(-color_jitter, color_jitter + 1, size=3)
            img[y: y + h, x: x + w] = color.clip(0, 255).astype(np.uint8)
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": cat,
                "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
            })
            ann_id += 1
        arrays[str(img_dir / fname)] = img
        images.append({"id": i, "file_name": fname, "height": size, "width": size})
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c, "name": f"cat{c}"} for c in (1, 2, 3)],
    }
    json_path = root / "instances.json"
    json_path.write_text(json.dumps(coco))
    return str(json_path), str(img_dir), arrays


def build_cfg(args, outdir: str, burnin: int | None = None, steps: int | None = None):
    from ..config import add_ubteacher_config, get_cfg

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    cfg.merge_from_file(RCNN_CFG if args.rcnn else FCOS_CFG)
    if args.rcnn:
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    else:
        cfg.MODEL.FCOS.NUM_CLASSES = 3
    cfg.TPU.CANVAS_LANDSCAPE = (args.size, args.size)
    cfg.TPU.CANVAS_PORTRAIT = (args.size, args.size)
    cfg.TPU.TEST_CANVAS = (args.size, args.size)
    cfg.TPU.MAX_GT = 8
    cfg.TPU.MAX_PSEUDO = 50
    cfg.TPU.NMS_CANDIDATES = 200
    cfg.TPU.DATA_THREADS = 2
    cfg.INPUT.MIN_SIZE_TRAIN = (args.size - 32,)
    cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    cfg.INPUT.MAX_SIZE_TRAIN = args.size
    cfg.INPUT.MIN_SIZE_TEST = args.size - 32
    cfg.INPUT.MAX_SIZE_TEST = args.size
    cfg.SOLVER.IMG_PER_BATCH_LABEL = 8
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 8
    cfg.SOLVER.MAX_ITER = args.steps if steps is None else steps
    # a backbone trained from scratch: a gentler LR, and clipping for R-CNN
    cfg.SOLVER.BASE_LR = 0.002 if args.rcnn else 0.01
    if args.rcnn:
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 10.0
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.SEMISUPNET.BURN_UP_STEP = args.burnin if burnin is None else burnin
    if getattr(args, "bbox_thresh", None) is not None:
        cfg.SEMISUPNET.BBOX_THRESHOLD = args.bbox_thresh
    if getattr(args, "oracle_pseudo", False):
        cfg.TPU.ORACLE_PSEUDO = True
    cfg.SEED = getattr(args, "seed", 0)
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.WEIGHTS = ""
    cfg.OUTPUT_DIR = outdir
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def _mean_metric(outdir: str, key: str, digits: int = 2):
    path = Path(outdir) / "metrics.json"
    if not path.exists():
        return None
    vals = [json.loads(line).get(key) for line in path.read_text().splitlines()]
    vals = [v for v in vals if v is not None]
    return round(float(np.mean(vals)), digits) if vals else None


def _trainer_cls(rcnn: bool):
    from ..engine.trainer import UBRCNNTeacherTrainer, UBTeacherTrainer

    return UBRCNNTeacherTrainer if rcnn else UBTeacherTrainer


def _log(msg: str) -> None:
    print(f"learning_sanity: {msg}", file=sys.stderr, flush=True)


def run_ablation(args) -> dict:
    """Supervised-only vs semi-supervised A/B.

    Both arms train the SAME K labeled images for the SAME total steps and
    evaluate on a HELD-OUT test set; the SSOD arm additionally sees M extra
    unlabeled images through the mutual-learning phase (the reference's
    value proposition, README.md:5-19; its mechanism at the reference's
    trainer.py:181-429).

      arm "sup":  BURN_UP_STEP = steps (never leaves supervised burn-in;
                  the unlabeled stream is fed the labeled images but the
                  burn-in loss never touches them);
      arm "ssod": BURN_UP_STEP = --burnin, unlabeled = the M extra images.

    Each arm's wall time (training and its evals) goes to stderr. The
    data and the runs' outputs live in a temporary directory, removed at
    the end."""
    device = tool_device(getattr(args, "cpu", False))
    with tempfile.TemporaryDirectory(prefix="ubt_ablation_") as tmp:
        return _ablation(args, device, Path(tmp))


def _ablation(args, device, tmp: Path) -> dict:
    from ..data.coco import load_coco_json

    seed = getattr(args, "seed", 0)
    train_json, train_dir, arrays = synthetic_coco(tmp / "train", args.images, args.size, seed=seed,
                                                   color_jitter=args.jitter)
    test_json, test_dir, test_arrays = synthetic_coco(tmp / "heldout", 16, args.size, seed=seed + 99,
                                                      color_jitter=args.jitter)
    arrays.update(test_arrays)
    dicts, meta = load_coco_json(train_json, train_dir)
    test_dicts, _ = load_coco_json(test_json, test_dir)
    k = args.label_images
    labeled, unlabeled = dicts[:k], dicts[k:]
    cls = _trainer_cls(args.rcnn)
    pseudo_key = "num_pseudo" if args.rcnn else "num_pseudo_cls"

    def run(tag: str, burnin: int, unlabel_dicts):
        datasets = {"train": labeled, "train_unlabel": unlabel_dicts, "test": test_dicts, "meta": meta}
        outdir = str(tmp / f"out_{tag}")
        cfg = build_cfg(args, outdir, burnin=burnin)
        t0 = time.perf_counter()
        trainer = cls(cfg, datasets=datasets, image_loader=arrays.__getitem__, device=device)
        trainer.train()
        res = {
            "ap_student": round(float(trainer.test(model="student")["AP"]), 2),
            "mean_pseudo_boxes": _mean_metric(outdir, pseudo_key),
        }
        if burnin < cfg.SOLVER.MAX_ITER:  # teacher exists post burn-in
            res["ap_teacher"] = round(float(trainer.test(model="teacher")["AP"]), 2)
        _log(f"arm {tag}: {cfg.SOLVER.MAX_ITER} steps (burn-in {burnin}) and eval in "
             f"{time.perf_counter() - t0:.1f} s on {device}")
        return res

    sup = run("sup", burnin=args.steps, unlabel_dicts=labeled)
    ssod = run("ssod", burnin=args.burnin, unlabel_dicts=unlabeled)
    out = {
        "ablation": "sup_only_vs_ssod",
        "detector": "rcnn" if args.rcnn else "fcos",
        "label_images": k,
        "unlabel_images": len(unlabeled),
        "steps": args.steps,
        "burnin": args.burnin,
        "jitter": args.jitter,
        "oracle_pseudo": bool(getattr(args, "oracle_pseudo", False)),
        "sup": sup,
        "ssod": ssod,
        "ssod_beats_sup_student": ssod["ap_student"] > sup["ap_student"],
        "ssod_beats_sup_teacher": ssod.get("ap_teacher", -1) > sup["ap_student"],
        "device": device_label(device),
    }
    print(json.dumps(out), flush=True)
    return out


def run_sanity(args) -> dict:
    """One run on half labeled, half unlabeled images; AP of the student
    before, and of both models after (outputs in a temporary directory,
    removed at the end)."""
    device = tool_device(args.cpu)
    with tempfile.TemporaryDirectory(prefix="ubt_sanity_") as tmp:
        return _sanity(args, device, Path(tmp))


def _sanity(args, device, tmp: Path) -> dict:
    from ..data.coco import load_coco_json

    json_path, img_dir, arrays = synthetic_coco(tmp, args.images, args.size)
    dicts, meta = load_coco_json(json_path, img_dir)
    n_label = args.images // 2
    datasets = {"train": dicts[:n_label], "train_unlabel": dicts[n_label:], "test": dicts[:16], "meta": meta}
    cfg = build_cfg(args, str(tmp / "output"))
    trainer = _trainer_cls(args.rcnn)(cfg, datasets=datasets, image_loader=arrays.__getitem__, device=device)

    pre = trainer.test(model="student")
    trainer.train()
    post_student = trainer.test(model="student")
    post_teacher = trainer.test(model="teacher")

    # the mean pseudo-box count over the mutual phase: a weak burn-in
    # teacher yields ~0 boxes at BBOX_THRESHOLD, and then the unlabeled
    # branch trains "everything is background" and degrades the student
    # (faithful to the reference, which has no guard either). If the
    # pseudo counts are ~0, raise --burnin.
    n_pseudo = _mean_metric(cfg.OUTPUT_DIR, "num_pseudo" if args.rcnn else "num_pseudo_cls", digits=1)
    out = {
        "detector": "rcnn" if args.rcnn else "fcos",
        "steps": args.steps,
        "ap_before": round(float(pre["AP"]), 2),
        "ap_student": round(float(post_student["AP"]), 2),
        "ap_teacher": round(float(post_teacher["AP"]), 2),
        "mean_pseudo_boxes": n_pseudo,
        "device": device_label(device),
    }
    print(json.dumps(out), flush=True)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rcnn", action="store_true")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--burnin", type=int, default=300)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--ablation", action="store_true", help="supervised-only vs SSOD A/B on held-out AP")
    ap.add_argument("--label-images", type=int, default=8, help="ablation: labeled images K (rest are unlabeled)")
    ap.add_argument("--jitter", type=int, default=40, help="ablation: per-instance color jitter amplitude")
    ap.add_argument("--bbox-thresh", type=float, default=None, help="override SEMISUPNET.BBOX_THRESHOLD")
    ap.add_argument("--oracle-pseudo", action="store_true",
                    help="ablation positive control: feed the unlabeled stream's ground truth as the "
                         "pseudo-label set (TPU.ORACLE_PSEUDO) in the SSOD arm")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the first card)")
    ap.add_argument("--seed", type=int, default=0, help="dataset + init seed")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="config KEY VALUE overrides, train_net style (e.g. --opts TPU.STEM_MODE conv)")
    return ap


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.ablation:
        return run_ablation(args)
    if args.images < 16:
        # both streams need a non-empty split or the two-stream loader
        # blocks forever waiting to fill an unlabeled batch
        ap.error("--images must be >= 16 (half labeled, half unlabeled)")
    return run_sanity(args)


if __name__ == "__main__":
    triton_cache_in_checkout()
    main()
