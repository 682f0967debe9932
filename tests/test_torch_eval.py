"""The port's host-side evaluation pieces against the JAX package's: the COCO
bbox evaluator (native C++ and numpy routes, and the transcribed pycocotools
oracle), the box-proposal recall table, the COCO json readers and the test
loader. Everything here is float64 numpy or json on the host, so the metrics
must agree to 1e-12; the loader's images differ only by the resize
arithmetic (see test_test_loader_matches_jax).
"""

import json

import numpy as np
import pytest
import torch

from coco_oracle import coco_eval_oracle
from test_coco_eval_oracle import _random_scenario
from ubteacher_tpu.data import coco as j_coco
from ubteacher_tpu.data.loader import TestDataLoader as JTestDataLoader
from ubteacher_tpu.evaluation import coco_eval as j_coco_eval
from ubteacher_tpu.evaluation import native as j_native
from ubteacher_tpu.evaluation.proposal_eval import proposal_metrics as j_proposal_metrics
from ubteacher_tpu_torch.config import add_ubteacher_config, get_cfg
from ubteacher_tpu_torch.data import coco
from ubteacher_tpu_torch.data.loader import TestDataLoader as TTestDataLoader
from ubteacher_tpu_torch.evaluation import coco_eval, native
from ubteacher_tpu_torch.evaluation.proposal_eval import proposal_metrics


def _evaluate(module, gt_anns, dt_anns, img_ids, num_classes):
    ev = module.COCOBboxEvaluator(num_classes)
    for img_id in img_ids:
        g = [a for a in gt_anns if a["image_id"] == img_id]
        d = [a for a in dt_anns if a["image_id"] == img_id]
        ev.add_ground_truth(
            img_id, np.asarray([a["bbox"] for a in g]).reshape(-1, 4), [a["category_id"] for a in g],
            iscrowd=[a["iscrowd"] for a in g], areas=[a["area"] for a in g],
        )
        if d:
            ev.add_detections(img_id, np.asarray([a["bbox"] for a in d]).reshape(-1, 4),
                              [a["score"] for a in d], [a["category_id"] for a in d])
    return ev.evaluate()


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("seed", range(8))
def test_coco_evaluator_matches_jax_and_oracle(seed, route, monkeypatch):
    """Seeded scenarios of test_coco_eval_oracle.py (crowds, every area
    range, > 100 detections in an image, empty images, tied scores)."""
    if route == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, "g++ could not build csrc/coco_eval_native.cpp"
    rng = np.random.default_rng(1000 + seed)
    num_classes = int(rng.integers(1, 5))
    gt_anns, dt_anns, img_ids = _random_scenario(rng, num_classes)
    got = _evaluate(coco_eval, gt_anns, dt_anns, img_ids, num_classes)
    ref = _evaluate(j_coco_eval, gt_anns, dt_anns, img_ids, num_classes)
    oracle = coco_eval_oracle(gt_anns, dt_anns, list(range(num_classes)), img_ids)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12, equal_nan=True, err_msg=k)
    for k in oracle:
        np.testing.assert_allclose(got[k], oracle[k], rtol=1e-9, atol=1e-9, equal_nan=True, err_msg=k)


def _proposal_records(rng, n_images):
    records = []
    for _ in range(n_images):
        n_gt, n_prop = int(rng.integers(0, 6)), int(rng.integers(0, 1200))
        xy = rng.uniform(0, 500, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(4, 300, (n_gt, 2))], 1)
        pxy = rng.uniform(0, 500, (n_prop, 2))
        props = np.concatenate([pxy, pxy + rng.uniform(4, 300, (n_prop, 2))], 1)
        if n_gt and n_prop:  # some proposals near the gts
            near = rng.integers(0, n_gt, min(n_prop, 20))
            props[: len(near)] = gt[near] + rng.normal(0, 6, (len(near), 4))
        records.append({
            "proposal_boxes": props,
            "objectness": np.round(rng.normal(0, 1, n_prop), 1),  # ties
            "gt_boxes": gt,
            "gt_areas": (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) * rng.choice([1.0, 0.7], n_gt),
        })
    return records


@pytest.mark.parametrize("seed", range(3))
def test_proposal_metrics_match_jax(seed):
    records = _proposal_records(np.random.default_rng(seed), 6)
    got, ref = proposal_metrics(records), j_proposal_metrics(records)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12, err_msg=k)


def _coco_json(path):
    data = {
        "categories": [{"id": 7, "name": "b"}, {"id": 3, "name": "a"}, {"id": 90, "name": "c"}],
        "images": [{"id": 5, "file_name": "x.jpg", "height": 480, "width": 640},
                   {"id": 2, "file_name": "y.jpg", "height": 640, "width": 427},
                   {"id": 9, "file_name": "z.jpg", "height": 300, "width": 300}],
        "annotations": [
            {"id": 1, "image_id": 5, "category_id": 90, "bbox": [10, 20, 30, 40], "area": 900.0, "iscrowd": 0},
            {"id": 2, "image_id": 5, "category_id": 3, "bbox": [0, 0, 100, 50], "iscrowd": 1},
            {"id": 3, "image_id": 2, "category_id": 7, "bbox": [5, 6, 7, 8], "ignore": 1},
            {"id": 4, "image_id": 2, "category_id": 7, "bbox": [50, 60, 70, 80]},
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f)


def test_coco_json_readers_match_jax(tmp_path):
    path = str(tmp_path / "ann.json")
    _coco_json(path)
    assert coco.load_coco_json(path, "/imgs") == j_coco.load_coco_json(path, "/imgs")
    assert coco.load_coco_unlabel_json(path, "/imgs") == j_coco.load_coco_unlabel_json(path, "/imgs")
    seed_path = str(tmp_path / "seed.json")
    coco.generate_supervision_seed_file(seed_path, 200, percents=(5.0,), seeds=2)
    with open(seed_path) as f:
        ours = json.load(f)
    j_coco.generate_supervision_seed_file(seed_path, 200, percents=(5.0,), seeds=2)
    with open(seed_path) as f:
        assert json.load(f) == ours
    dicts = [{"image_id": i, "annotations": []} for i in range(200)]
    assert coco.divide_label_unlabel(dicts, 5.0, 1, seed_path) == j_coco.divide_label_unlabel(dicts, 5.0, 1, seed_path)


def _loader_cfgs():
    from ubteacher_tpu.config import add_ubteacher_config as j_add, get_cfg as j_get

    out = []
    for get, add in ((j_get, j_add), (get_cfg, add_ubteacher_config)):
        cfg = get()
        add(cfg)
        cfg.merge_from_list(["TPU.TEST_CANVAS", (48, 80), "INPUT.MIN_SIZE_TEST", 40, "INPUT.MAX_SIZE_TEST", 70,
                             "TPU.DATA_THREADS", 2])
        out.append(cfg)
    return out


def test_test_loader_matches_jax():
    """Same order, orientation groups, canvases, true sizes and scales, and
    bitwise the same images: the JAX loader resizes uint8 pixels with
    cv2.resize, the port with its numpy replica of cv2's fixed-point
    arithmetic."""
    jcfg, tcfg = _loader_cfgs()
    rng = np.random.default_rng(0)
    # landscape, portrait, square, a size past MAX_SIZE_TEST, one the canvas caps
    sizes = [(30, 50), (64, 40), (45, 45), (20, 90), (100, 60), (33, 47), (70, 20), (41, 80)]
    pixels = {f"img{i}": rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for i, (h, w) in enumerate(sizes)}
    dicts = [{"file_name": f"img{i}", "image_id": 100 + i, "height": h, "width": w, "annotations": []}
             for i, (h, w) in enumerate(sizes)]
    got = list(TTestDataLoader(tcfg, dicts, batch_size=3, image_loader=pixels.__getitem__))
    ref = list(JTestDataLoader(jcfg, dicts, batch_size=3, image_loader=pixels.__getitem__))
    assert len(got) == len(ref) == len(TTestDataLoader(tcfg, dicts, batch_size=3))
    for g, r in zip(got, ref):
        assert g["image_ids"] == r["image_ids"] and g["num_valid"] == r["num_valid"]
        assert tuple(g["images"].shape) == r["images"].shape
        assert g["images"].dtype == torch.float32
        np.testing.assert_array_equal(g["hw"].numpy(), r["hw"])
        np.testing.assert_array_equal(g["scales"].numpy(), r["scales"])
        np.testing.assert_array_equal(g["images"].numpy(), r["images"])
    assert {tuple(b["images"].shape[1:3]) for b in got} == {(48, 80), (80, 48)}
