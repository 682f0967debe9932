"""The port's evaluation entry points against the JAX package's, on the CPU
at the small test configurations of tests/torch_parity.py, from the same
weights (params_from_jax) and the same batches:

  * FCOS make_fcos_inference_fn with the fused stem (the port's "pallas"
    mode, JAX's "pallas_interpret": the Pallas kernel interpreted), on a
    landscape and a portrait canvas;
  * inference_on_dataset over the same pre-made batches in both packages,
    and the oracle: ground truth fed back as detection rows scores AP 100;
  * R-CNN make_rcnn_proposal_fn.

Tolerances: the kept sets and classes equal; boxes within 5e-3 px and
scores within 1e-5 (float32 convolutions summed in other orders by XLA and
PyTorch's CPU kernels move a box by about 1e-5 relative); COCO metrics,
computed in float64 from those detections, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    CANVAS,
    RCNN_CANVAS,
    RCNN_CLS_BIAS,
    jax_model_and_params,
    jax_rcnn_model_and_params,
    port_model,
    port_rcnn_model,
    small_cfgs,
    small_rcnn_cfgs,
    tmp_budget,
)

NUM_CLASSES = 4


@pytest.fixture(scope="module")
def fcos():
    """(jcfg, tcfg, JAX params, jitted JAX infer, port model, port infer)
    with the fused stem and a cls bias that lets the random-init head pass
    INFERENCE_TH_TEST."""
    from ubteacher_tpu.evaluation.evaluator import make_fcos_inference_fn as j_make
    from ubteacher_tpu_torch.evaluation.evaluator import make_fcos_inference_fn

    jcfg, _ = small_cfgs(["TPU.STEM_MODE", "pallas_interpret"])
    _, tcfg = small_cfgs(["TPU.STEM_MODE", "pallas"])
    jmodel, params = jax_model_and_params(jcfg, seed=1, cls_bias=[0.5, -1.0, 0.0, -0.5])
    tmodel = port_model(tcfg, params).eval()
    assert tmodel.backbone.stem_mode == "pallas"
    jparams = jax.tree.map(jnp.asarray, params)
    return jcfg, tcfg, jparams, j_make(jcfg, jmodel), tmodel, make_fcos_inference_fn(tcfg)


def _batch(seed, canvas, true_hw, image_ids):
    rng = np.random.default_rng(seed)
    b = len(image_ids)
    images = np.zeros((b,) + canvas + (3,), np.float32)
    for i, (h, w) in enumerate(true_hw):
        images[i, :h, :w] = rng.normal(110, 40, (h, w, 3)).clip(0, 255)
    return {
        "images": images, "hw": np.asarray(true_hw, np.float32),
        "scales": np.asarray([0.8, 1.25][:b], np.float32), "image_ids": list(image_ids), "num_valid": b,
    }


BATCHES = [
    _batch(10, CANVAS, [(64, 96), (50, 80)], [1, 2]),
    _batch(11, CANVAS[::-1], [(96, 64), (90, 52)], [3, 4]),
]


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare_detections(got, ref):
    np.testing.assert_array_equal(_np(got.mask), np.asarray(ref.mask))
    assert int(got.mask.sum()) > 0
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(_np(got.classes)[mask], np.asarray(ref.classes)[mask])
    np.testing.assert_allclose(_np(got.boxes)[mask], np.asarray(ref.boxes)[mask], rtol=0, atol=5e-3)
    np.testing.assert_allclose(_np(got.scores), np.asarray(ref.scores), rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", [0, 1], ids=["landscape", "portrait"])
def test_fcos_inference_fn_matches_jax(fcos, which):
    _, _, jparams, j_infer, tmodel, t_infer = fcos
    batch = BATCHES[which]
    ref = j_infer(jparams, jnp.asarray(batch["images"]), jnp.asarray(batch["hw"]))
    got = t_infer(tmodel, torch.from_numpy(batch["images"]), torch.from_numpy(batch["hw"]))
    _compare_detections(got, ref)


def _dataset_dicts():
    """Two gt boxes per image in original pixels, one crowd box."""
    dicts = []
    for batch in BATCHES:
        for i, img_id in enumerate(batch["image_ids"]):
            h, w = (batch["hw"][i] / batch["scales"][i]).round()
            anns = [
                {"bbox": [0.1 * w, 0.1 * h, 0.6 * w, 0.7 * h], "category_id": img_id % NUM_CLASSES, "iscrowd": 0},
                {"bbox": [0.3 * w, 0.2 * h, 0.95 * w, 0.9 * h], "category_id": 0, "iscrowd": int(img_id == 3)},
            ]
            dicts.append({"image_id": img_id, "height": float(h), "width": float(w), "annotations": anns})
    return dicts


def test_inference_on_dataset_matches_jax(fcos):
    from ubteacher_tpu.evaluation.evaluator import inference_on_dataset as j_inference_on_dataset
    from ubteacher_tpu_torch.evaluation.evaluator import inference_on_dataset

    jcfg, tcfg, jparams, j_infer, tmodel, t_infer = fcos
    dicts = _dataset_dicts()
    ref = j_inference_on_dataset(jcfg, jparams, None, BATCHES, dicts, infer_fn=j_infer)
    got = inference_on_dataset(tcfg, tmodel, BATCHES, dicts, infer_fn=t_infer)
    # the default infer_fn is make_fcos_inference_fn at NMS_CRITERIA_TEST
    default = inference_on_dataset(tcfg, tmodel, BATCHES, dicts)
    np.testing.assert_array_equal(np.asarray(list(default.values())), np.asarray(list(got.values())))
    assert set(got) == set(ref) and got["AP"] > 0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, equal_nan=True, err_msg=k)


def test_ground_truth_as_detections_scores_ap_100():
    from ubteacher_tpu_torch.evaluation.evaluator import evaluate_detection_rows

    dicts = _dataset_dicts()
    rows = [[d["image_id"], o["bbox"][0], o["bbox"][1], o["bbox"][2] - o["bbox"][0], o["bbox"][3] - o["bbox"][1],
             1.0, o["category_id"]] for d in dicts for o in d["annotations"] if not o["iscrowd"]]
    res = evaluate_detection_rows(np.asarray(rows), dicts, NUM_CLASSES)
    # (AR1 stays below 100 where an image holds two boxes of one class)
    for k in ("AP", "AP50", "AP75", "AR10", "AR100"):
        assert res[k] == pytest.approx(100.0), k


def test_rcnn_proposal_fn_matches_jax():
    from ubteacher_tpu.engine.rcnn_trainer import make_rcnn_proposal_fn as j_make
    from ubteacher_tpu_torch.engine.rcnn_trainer import make_rcnn_proposal_fn

    jcfg, tcfg = small_rcnn_cfgs()
    jmodel, params = jax_rcnn_model_and_params(jcfg, seed=0, cls_bias=RCNN_CLS_BIAS)
    rng = np.random.default_rng(3)
    images = rng.normal(110, 40, (2,) + RCNN_CANVAS + (3,)).clip(0, 255).astype(np.float32)
    hw = np.asarray([RCNN_CANVAS, (56, 48)], np.float32)
    rb, rs, rm = (np.asarray(a) for a in j_make(jcfg, jmodel)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(images), jnp.asarray(hw)))
    gb, gs, gm = (t.numpy() for t in make_rcnn_proposal_fn(tcfg)(
        port_rcnn_model(tcfg, params), torch.from_numpy(images), torch.from_numpy(hw)))
    np.testing.assert_array_equal(gm, rm)
    assert gm.sum() > 0
    np.testing.assert_allclose(gb[rm], rb[rm], rtol=0, atol=5e-3)
    np.testing.assert_allclose(gs[rm], rs[rm], rtol=1e-4, atol=1e-4)
