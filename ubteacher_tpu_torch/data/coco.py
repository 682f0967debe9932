"""COCO dataset loading and labeled/unlabeled splitting (the port's copy of
ubteacher_tpu.data.coco; pure json and numpy).

Host-side equivalents of the reference's data registration and split:
  * load_coco_json mirrors detectron2.data.datasets.load_coco_json as the
    reference consumes it (sorted image ids, contiguous category remapping,
    xywh -> xyxy, iscrowd filtering left to the mapper);
  * divide_label_unlabel is byte-identical in semantics to the reference
    (reference: ubteacher/data/build.py:30-53) — indices come from the
    dataseed JSON keyed [percent][seed];
  * load_coco_unlabel_json mirrors the image-only registration
    (reference: ubteacher/data/datasets/builtin.py:27-101).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


def load_coco_json(json_file: str, image_root: str) -> List[Dict]:
    with open(json_file, "r") as f:
        coco = json.load(f)

    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat_id_map = {c["id"]: i for i, c in enumerate(cats)}
    thing_classes = [c["name"] for c in cats]

    imgs = sorted(coco["images"], key=lambda im: im["id"])
    anns_by_img: Dict[int, List[Dict]] = {}
    for ann in coco.get("annotations", []):
        anns_by_img.setdefault(ann["image_id"], []).append(ann)

    dataset_dicts = []
    for im in imgs:
        record = {
            "file_name": os.path.join(image_root, im["file_name"]),
            "height": im["height"],
            "width": im["width"],
            "image_id": im["id"],
        }
        objs = []
        for ann in anns_by_img.get(im["id"], []):
            if ann.get("ignore", 0):
                continue
            x, y, w, h = ann["bbox"]
            obj = {
                "bbox": [x, y, x + w, y + h],  # xyxy
                "category_id": cat_id_map[ann["category_id"]],
                "iscrowd": ann.get("iscrowd", 0),
                "area": ann.get("area", w * h),
                "id": ann.get("id", -1),
            }
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)

    meta = {
        "thing_classes": thing_classes,
        "contiguous_to_coco_id": {i: c["id"] for i, c in enumerate(cats)},
    }
    return dataset_dicts, meta


def load_coco_unlabel_json(json_file: str, image_root: str) -> List[Dict]:
    """Image-only dicts for the unlabeled stream
    (reference: datasets/builtin.py:56-101)."""
    with open(json_file, "r") as f:
        coco = json.load(f)
    imgs = sorted(coco["images"], key=lambda im: im["id"])
    return [
        {
            "file_name": os.path.join(image_root, im["file_name"]),
            "height": im["height"],
            "width": im["width"],
            "image_id": im["id"],
            "annotations": [],
        }
        for im in imgs
    ]


def divide_label_unlabel(
    dataset_dicts: List[Dict],
    sup_percent: float,
    random_data_seed: int,
    random_data_seed_path: str,
) -> Tuple[List[Dict], List[Dict]]:
    """Deterministic split via the pre-generated seed file
    (reference: build.py:30-53)."""
    num_all = len(dataset_dicts)
    num_label = int(sup_percent / 100.0 * num_all)

    with open(random_data_seed_path, "r") as f:
        coco_random_idx = json.load(f)

    labeled_idx = np.array(coco_random_idx[str(sup_percent)][str(random_data_seed)])
    assert labeled_idx.shape[0] == num_label, "Number of READ_DATA is mismatched."

    labeled_set = set(int(i) for i in labeled_idx)
    label_dicts, unlabel_dicts = [], []
    for i, d in enumerate(dataset_dicts):
        (label_dicts if i in labeled_set else unlabel_dicts).append(d)
    return label_dicts, unlabel_dicts


def generate_supervision_seed_file(
    path: str, num_images: int, percents=(0.5, 1.0, 2.0, 5.0, 10.0), seeds=10
) -> None:
    """Create a COCO_supervision.txt-style file for datasets that lack one
    (the reference ships a frozen one for coco_2017_train only)."""
    out = {}
    for p in percents:
        n = int(p / 100.0 * num_images)
        out[str(p)] = {}
        for s in range(seeds):
            rng = np.random.default_rng(s)
            out[str(p)][str(s)] = rng.choice(num_images, size=n, replace=False).tolist()
    with open(path, "w") as f:
        json.dump(out, f)
