"""The port's Faster R-CNN pieces against ubteacher_tpu's, on the CPU.

Anchors, both box transforms, the matcher, the row gather, ROIAlign, the RPN
(proposals, labeling, losses), the box head's sampling, losses and
inference, the detector's three stages from a JAX initialisation carried
over by params_from_jax, and the inference function. The kernel wrappers take their plain versions for CPU tensors, so
these tests go through the wrappers; the JAX side runs its Pallas kernels in
interpret mode where its default dispatch reaches one (the matcher, the row
scatter), as the JAX package's own tests run them.

Tolerances, and why:
  * Anchors, box deltas, the matcher, sampling and every index or mask are
    exact: the same float32 operations in the same order, and integer
    outputs (the matcher is bitwise, as the CUDA kernel must be to it). The
    one exception is a log (the dw, dh deltas), where XLA's and torch's
    float32 log may round 1 ulp apart (rtol 2e-7).
  * ROIAlign: 1e-5 (rtol and atol). The port sums the bilinear taps of a
    gather, the JAX reference contracts dense weight rows; float32 sums in
    two orders.
  * Losses, gradients and decoded boxes: rtol 1e-5 / atol 1e-6, float32
    transcendental and reduction order (XLA's log/exp/sum vs torch's).
  * The detector's stage outputs: rtol 1e-4 and an atol of 1e-5 of the
    tensor's largest magnitude: float32 convolutions summed in another order
    by XLA and by torch, through 18 layers, leave errors of a few 1e-6 of
    the scale, which are large relative to the entries near zero.
  * Detections of the whole detector: the kept set, its classes and its
    order equal; scores and boundary logits within 1e-4; boxes within 5e-3
    pixels on the 64- and 96-pixel canvases (measured up to 2.8e-3): the
    stage outputs' 1e-5 relative differences reach the box deltas through
    ROIAlign and two fully connected layers of 12,544 and 1,024 inputs, and
    a decoded coordinate near 0 has no relative slack. The cls_score bias of
    class 0 is raised so that the random-init teacher scores pass
    BBOX_THRESHOLD 0.7 (softmax 0.80 against 3 others).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.modeling import fast_rcnn as JF
from ubteacher_tpu.modeling import rpn as JR
from ubteacher_tpu.modeling.anchors import generate_anchors as j_generate_anchors
from ubteacher_tpu.modeling.box_regression import Box2BoxTransform as JB2B
from ubteacher_tpu.modeling.box_regression import Box2BoxXYXYTransform as JXYXY
from ubteacher_tpu.modeling.matcher import match_anchors_batched as j_match_anchors_batched
from ubteacher_tpu.ops.pallas.roi_align_pallas import multilevel_roi_align_pallas
from ubteacher_tpu.ops.pallas.row_gather_pallas import take_rows as j_take_rows
from ubteacher_tpu.ops.roi_align import multilevel_roi_align as j_multilevel_roi_align
from ubteacher_tpu.structures import PaddedInstances as JInstances
from ubteacher_tpu_torch.modeling import fast_rcnn as TF
from ubteacher_tpu_torch.modeling import rpn as TR
from ubteacher_tpu_torch.modeling.anchors import generate_anchors
from ubteacher_tpu_torch.modeling.box_regression import Box2BoxTransform, Box2BoxXYXYTransform
from ubteacher_tpu_torch.modeling.matcher import match_anchors_batched
from ubteacher_tpu_torch.ops.kernels import matcher_cuda, roi_align_cuda, row_scatter_cuda
from ubteacher_tpu_torch.ops.roi_align import multilevel_roi_align
from ubteacher_tpu_torch.ops.row_gather import take_rows
from ubteacher_tpu_torch.structures import PaddedInstances

from torch_parity import (
    RCNN_B,
    RCNN_CANVAS,
    RCNN_SEED,
    jax_rcnn_model_and_params,
    port_rcnn_model,
    rcnn_setup,
    small_rcnn_cfgs,
)

STRIDES = (4, 8, 16, 32, 64)
SIZES = [[32], [64], [128], [256], [512]]
RATIOS = [[0.5, 1.0, 2.0]]
LEVELS = (2, 3, 4, 5)
DET_ATOL = {"boxes": 5e-3, "scores": 1e-4, "box_std": 1e-4}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_boxes(rng, shape, w=300.0, h=200.0, min_wh=1.0, max_wh=150.0):
    x0 = rng.uniform(0, w, shape)
    y0 = rng.uniform(0, h, shape)
    bw = rng.uniform(min_wh, max_wh, shape)
    bh = rng.uniform(min_wh, max_wh, shape)
    return np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)


def _instances(boxes, mask, classes=None, scores=None, box_std=None):
    """The same padded instances in both packages."""
    b, m = mask.shape
    classes = np.zeros((b, m), np.int32) if classes is None else classes
    scores = np.ones((b, m), np.float32) if scores is None else scores
    box_std = np.zeros((b, m, 4), np.float32) if box_std is None else box_std
    j = JInstances(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(scores),
                   jnp.asarray(box_std), jnp.asarray(mask))
    t = PaddedInstances(_t(boxes), _t(classes).long(), _t(scores), _t(box_std), _t(mask))
    return j, t


# --------------------------------------------------------------------------
# anchors and box transforms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("canvas", [(64, 96), (768, 1344), (100, 75)])
def test_anchors_match_jax(canvas):
    ref = j_generate_anchors(canvas, STRIDES, SIZES, RATIOS, 0.0)
    got = generate_anchors(canvas, STRIDES, SIZES, RATIOS, 0.0, device="cpu")
    assert got["level_lengths"] == ref["level_lengths"]
    for k in ("anchors", "level_ids", "cell_origins"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("cls", ["xywh", "xyxy"])
def test_box_transforms_match_jax(cls):
    rng = np.random.default_rng(0)
    src = _random_boxes(rng, (64,))
    tgt = src + rng.normal(0, 8, (64, 4)).astype(np.float32)
    deltas = rng.normal(0, 1, (64, 8)).astype(np.float32)
    if cls == "xywh":
        j, t = JB2B((1.0, 1.0, 1.0, 1.0)), Box2BoxTransform((1.0, 1.0, 1.0, 1.0))
        deltas[:3, 2] = 9.0  # past the scale clamp
    else:
        j, t = JXYXY((10.0, 10.0, 5.0, 5.0)), Box2BoxXYXYTransform((10.0, 10.0, 5.0, 5.0))
        deltas[:3, 0] = 1e4  # past the edge clamp
    got = _np(t.get_deltas(_t(src), _t(tgt)))
    ref = np.asarray(j.get_deltas(jnp.asarray(src), jnp.asarray(tgt)))
    if cls == "xyxy":
        np.testing.assert_array_equal(got, ref)
    else:  # dw, dh go through log: XLA's and torch's may round 1 ulp apart
        np.testing.assert_array_equal(got[:, :2], ref[:, :2])
        np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)
    np.testing.assert_allclose(
        _np(t.apply_deltas(_t(deltas), _t(src))),
        np.asarray(j.apply_deltas(jnp.asarray(deltas), jnp.asarray(src))), rtol=1e-6, atol=1e-4)


def test_xyxy_get_deltas_keeps_the_plus_one_width():
    """get_deltas normalises by width + 1, apply_deltas by width: a round
    trip does not return the target (box_regression.py:81-82)."""
    t = Box2BoxXYXYTransform((1.0, 1.0, 1.0, 1.0))
    src = torch.tensor([[0.0, 0.0, 9.0, 19.0]])
    tgt = torch.tensor([[1.0, 2.0, 11.0, 23.0]])
    d = t.get_deltas(src, tgt)
    np.testing.assert_allclose(_np(d), [[0.1, 0.2, 0.1, 0.2]], rtol=1e-6)
    np.testing.assert_allclose(_np(t.apply_deltas(d, src)), [[0.9, 1.9, 10.8, 22.8]], rtol=1e-6)


# --------------------------------------------------------------------------
# matcher
# --------------------------------------------------------------------------


def _matcher_case(seed):
    rng = np.random.default_rng(seed)
    b, m, a = 4, 12, 900
    anchors = _random_boxes(rng, (a,))
    gt = _random_boxes(rng, (b, m), min_wh=4.0, max_wh=200.0)
    mask = rng.random((b, m)) < 0.7
    mask[0] = False                       # an empty image
    mask[1, -1] = True                    # a valid last slot
    gt[2, 3] = gt[2, 1]                   # duplicated gts: IoU ties across gts
    mask[2, 1] = mask[2, 3] = True
    anchors[5:9] = anchors[4]             # duplicated anchors: per-gt best ties
    anchors[10] = gt[3, 0]                # IoU exactly 1
    anchors[11] = [0.0, 0.0, 0.0, 0.0]    # degenerate
    gt[3, 2] = [5.0, 5.0, 5.0, 9.0]       # zero-area gt
    return anchors, gt, mask


@pytest.mark.parametrize("seed", range(4))
def test_matcher_bitwise_matches_jax(seed):
    anchors, gt, mask = _matcher_case(seed)
    idx, lab = match_anchors_batched(_t(anchors), _t(gt), _t(mask))
    for method in ("auto", "xla"):  # interpreted Pallas, then XLA
        j_idx, j_lab = j_match_anchors_batched(
            jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask), method=method)
        np.testing.assert_array_equal(_np(idx), np.asarray(j_idx), err_msg=method)
        np.testing.assert_array_equal(_np(lab), np.asarray(j_lab), err_msg=method)
    assert (_np(lab)[0] == 0).all()
    assert set(np.unique(_np(lab))) <= {-1, 0, 1}


def test_matcher_thresholds_are_inclusive():
    """IoU exactly 0.3 is ignore, exactly 0.7 positive (>=, not >)."""
    gt = np.asarray([[[0.0, 0.0, 10.0, 10.0]]], np.float32)
    anchors = np.asarray([[0.0, 0.0, 10.0, 7.0], [0.0, 0.0, 10.0, 3.0], [50.0, 50.0, 60.0, 60.0]],
                         np.float32)
    _, lab = match_anchors_batched(_t(anchors), _t(gt), torch.ones((1, 1), dtype=torch.bool),
                                   allow_low_quality=False)
    assert _np(lab).tolist() == [[1, -1, 0]]


def test_samplers_match_jax_top_k():
    """random_priority_topk and sample_topk_indices against lax.top_k over
    the same priorities (the JAX sampler's exact branch), ties included:
    equal priorities come out in ascending index order."""
    from ubteacher_tpu.modeling.matcher import sample_topk_indices as j_sample_topk_indices
    from ubteacher_tpu_torch.modeling.matcher import NEG_INF, random_priority_topk, sample_topk_indices

    rng = np.random.default_rng(12)
    eligible = rng.random((3, 500)) < 0.1
    eligible[2] = False                      # nothing to sample
    pri = rng.random((3, 500)).astype(np.float32)
    pri[:, 100:120] = 0.5                    # ties
    eligible[0, 100:120] = True
    masked = np.where(eligible, pri, np.float32(NEG_INF))
    j_idx, j_ok = j_sample_topk_indices(jnp.asarray(masked), 64)
    for got in (random_priority_topk(_t(eligible), 64, _t(pri)), sample_topk_indices(_t(masked), 64)):
        np.testing.assert_array_equal(_np(got[0])[np.asarray(j_ok)], np.asarray(j_idx)[np.asarray(j_ok)])
        np.testing.assert_array_equal(_np(got[1]), np.asarray(j_ok))
    assert int(j_ok[2].sum()) == 0 and int(j_ok[0].sum()) == 64


# --------------------------------------------------------------------------
# row gather
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", [3, 12])
def test_take_rows_and_gradient_match_jax(d):
    rng = np.random.default_rng(d)
    b, length, k = 3, 50, 40
    x = rng.normal(size=(b, length, d)).astype(np.float32)
    rows = rng.integers(0, length, (b, k))
    rows[:, :5] = 7  # duplicates accumulate
    cot = rng.normal(size=(b, k, d)).astype(np.float32)

    xt = _t(x).requires_grad_(True)
    out = take_rows(xt, _t(rows))
    (out * _t(cot)).sum().backward()

    j_out, j_vjp = jax.vjp(lambda v: j_take_rows(v, jnp.asarray(rows, jnp.int32)), jnp.asarray(x))
    (j_grad,) = j_vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(_np(out), np.asarray(j_out))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(j_grad), rtol=1e-6, atol=1e-6)
    dup = cot[:, :5].sum(1) + (cot * (rows == 7)[..., None])[:, 5:].sum(1)
    np.testing.assert_allclose(_np(xt.grad)[:, 7], dup, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# ROIAlign
# --------------------------------------------------------------------------


def _pyramid(rng, b, c, h2, w2):
    """NCHW levels p2..p5 for the port and NHWC for the JAX package."""
    feats = [rng.normal(size=(b, c, h2 >> i, w2 >> i)).astype(np.float32) for i in range(4)]
    return feats, {f"p{lv}": jnp.asarray(f.transpose(0, 2, 3, 1)) for lv, f in zip(LEVELS, feats)}


def _rois(rng, b, r, img_h, img_w, max_size):
    cx = rng.uniform(8, img_w - 8, (b, r))
    cy = rng.uniform(8, img_h - 8, (b, r))
    sz = rng.uniform(4, max_size, (b, r))
    ar = rng.uniform(0.5, 2.0, (b, r))
    w = np.minimum(sz * np.sqrt(ar), 2 * np.minimum(cx, img_w - cx))
    h = np.minimum(sz / np.sqrt(ar), 2 * np.minimum(cy, img_h - cy))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_bin_weights_match_jax(sampling_ratio):
    """bin_sample_positions (the adaptive grid capped at ADAPTIVE_MAX_S for
    sampling_ratio 0) and bin_axis_weights, the rows the JAX matmul
    formulation contracts: positions, coefficients and weights to 1e-6."""
    from ubteacher_tpu.ops.roi_align import bin_axis_weights as j_weights
    from ubteacher_tpu.ops.roi_align import bin_sample_positions as j_positions
    from ubteacher_tpu_torch.ops.roi_align import bin_axis_weights, bin_sample_positions

    rng = np.random.default_rng(sampling_ratio)
    start = rng.uniform(-0.5, 30.0, 40).astype(np.float32)
    extent = rng.uniform(0.0, 80.0, 40).astype(np.float32)
    extent[:3] = [42.0, 14.0, 1e-6]          # whole multiples of P, and degenerate
    pos, coef = bin_sample_positions(_t(start), _t(extent), 7, sampling_ratio)
    j_pos, j_coef = j_positions(jnp.asarray(start), jnp.asarray(extent), 7, sampling_ratio)
    np.testing.assert_array_equal(_np(coef), np.asarray(j_coef))
    np.testing.assert_allclose(_np(pos), np.asarray(j_pos), rtol=1e-6, atol=1e-6)
    clipped = np.clip(np.asarray(j_pos), 0.0, 63.0)
    np.testing.assert_allclose(_np(bin_axis_weights(_t(clipped), coef, 64)),
                               np.asarray(j_weights(jnp.asarray(clipped), j_coef, 64)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_roi_align_and_gradient_match_jax(sampling_ratio):
    rng = np.random.default_rng(sampling_ratio)
    b, c, r = 2, 8, 24
    feats, pyr = _pyramid(rng, b, c, 48, 64)
    # sizes up to 2x the canvas reach p5 with grids past ADAPTIVE_MAX_S
    boxes = _rois(rng, b, r, 192, 256, 400)
    boxes[0, 0] = [-20.0, -10.0, 300.0, 230.0]  # samples clipped at the border
    cot = rng.normal(size=(b, r, 7, 7, c)).astype(np.float32)

    tf = [_t(f).requires_grad_(True) for f in feats]
    out = multilevel_roi_align(tf, _t(boxes), LEVELS, 7, sampling_ratio)
    (out * _t(cot)).sum().backward()

    def ref(p):
        return j_multilevel_roi_align(p, jnp.asarray(boxes), ("p2", "p3", "p4", "p5"), 7,
                                      sampling_ratio, method="matmul")

    j_out, j_vjp = jax.vjp(jax.jit(ref), pyr)
    (j_grad,) = j_vjp(jnp.asarray(cot))
    assert out.shape == (b, r, 7, 7, c)
    np.testing.assert_allclose(_np(out), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    for lv, f in zip(LEVELS, tf):
        g = np.zeros(f.shape, np.float32) if f.grad is None else _np(f.grad)  # a level no roi uses
        np.testing.assert_allclose(g, np.asarray(j_grad[f"p{lv}"]).transpose(0, 3, 1, 2),
                                   rtol=1e-5, atol=1e-5, err_msg=f"p{lv}")


def test_roi_align_matches_interpreted_pallas():
    """On rois that fit the Pallas kernel's window, where it is exact."""
    rng = np.random.default_rng(5)
    b, c, r = 2, 16, 12
    feats, pyr = _pyramid(rng, b, c, 48, 64)
    boxes = _rois(rng, b, r, 192, 256, 160)
    out = multilevel_roi_align([_t(f) for f in feats], _t(boxes), LEVELS, 7, 0)
    ref = multilevel_roi_align_pallas(tuple(pyr[f"p{lv}"] for lv in LEVELS), jnp.asarray(boxes),
                                      LEVELS, 7, 0, interpret=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# RPN
# --------------------------------------------------------------------------


def _rpn_inputs(seed, canvas=(32, 48), b=2):
    rng = np.random.default_rng(seed)
    anch = j_generate_anchors(canvas, STRIDES, SIZES, RATIOS, 0.0)
    n_loc = sum(anch["level_lengths"]) // 3
    logits = rng.normal(size=(b, n_loc, 3)).astype(np.float32)
    deltas = rng.normal(0, 0.3, size=(b, n_loc, 3, 4)).astype(np.float32)
    hw = np.asarray([[canvas[0], canvas[1]], [canvas[0] - 10, canvas[1] - 20]], np.float32)[:b]
    return anch, logits, deltas, hw


@pytest.mark.parametrize("pre_nms,cap,min_size", [(2000, 5000, 0.0), (50, 100, 2.0)])
def test_find_top_proposals_matches_jax(pre_nms, cap, min_size):
    anch, logits, deltas, hw = _rpn_inputs(0)
    args = dict(pre_nms_topk=pre_nms, post_nms_topk=48, nms_thresh=0.7, total_candidates=cap,
                min_size=min_size)
    got = TR.find_top_proposals(
        _t(anch["anchors"]), anch["level_lengths"], _t(logits), _t(deltas), _t(hw),
        Box2BoxTransform((1.0, 1.0, 1.0, 1.0)), cell_origins=_t(anch["cell_origins"]), **args)
    ref = jax.jit(lambda lo, de: JR.find_top_proposals(
        anch["anchors"], anch["level_lengths"], anch["level_ids"], lo, de, jnp.asarray(hw),
        JB2B((1.0, 1.0, 1.0, 1.0)), cell_origins=anch["cell_origins"], **args))(
        jnp.asarray(logits), jnp.asarray(deltas))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    assert _np(got[2]).sum() > 0
    np.testing.assert_allclose(_np(got[1]), np.asarray(ref[1]), rtol=1e-6)
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]), rtol=1e-5, atol=1e-4)


def _rpn_draws(key, b, a):
    """The uniforms JAX's label_anchors draws per image (rpn.py:155-166)."""
    keys = jax.random.split(key, b)
    pri = [[np.asarray(jax.random.uniform(k, (a,))) for k in jax.random.split(ki)] for ki in keys]
    return keys, _t(np.asarray(pri, np.float32))


@pytest.mark.parametrize("use_conf", [False, True])
def test_label_anchors_and_rpn_losses_match_jax(use_conf):
    anch, logits, deltas, hw = _rpn_inputs(1)
    rng = np.random.default_rng(2)
    b, m = 2, 6
    gt = _random_boxes(rng, (b, m), w=30, h=20, min_wh=6.0, max_wh=30.0)
    mask = np.zeros((b, m), bool)
    mask[0, :4] = True  # image 1 has no gt: all background, confidence 0
    scores = rng.uniform(0.5, 1.0, (b, m)).astype(np.float32)
    jg, tg = _instances(gt, mask, scores=scores)
    anchors = anch["anchors"]
    a = anchors.shape[0]
    keys, pri = _rpn_draws(jax.random.PRNGKey(3), b, a)
    box2box = (JB2B((1.0, 1.0, 1.0, 1.0)), Box2BoxTransform((1.0, 1.0, 1.0, 1.0)))

    j_matched = j_match_anchors_batched(anchors, jg.boxes, jg.mask)
    j_samp = jax.jit(jax.vmap(lambda g, k, one_hw, mi, lb: JR.label_anchors(
        anchors, g, 64, 0.25, k, use_conf,
        anchor_valid=JR.anchor_validity(anch["cell_origins"], one_hw), matched=(mi, lb),
    )))(jg, keys, jnp.asarray(hw), *j_matched)
    t_matched = match_anchors_batched(_t(anchors), tg.boxes, tg.mask)
    t_samp = TR.label_anchors(tg, 64, 0.25, pri, use_conf,
                              TR.anchor_validity(_t(anch["cell_origins"]), _t(hw)), t_matched)
    for k in ("idx", "labels", "ok", "boxes", "confid"):
        np.testing.assert_array_equal(_np(t_samp[k]), np.asarray(j_samp[k]), err_msg=k)
    assert int(t_samp["ok"].sum()) == 2 * 64

    def j_loss(lo, de):
        out = JR.rpn_losses(anchors, lo, de, j_samp, box2box[0], 64)
        return out["loss_rpn_cls"] + 2.0 * out["loss_rpn_loc"], out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(deltas))
    tl, td = _t(logits).requires_grad_(True), _t(deltas).requires_grad_(True)
    t_out = TR.rpn_losses(_t(anchors), tl, td, t_samp, box2box[1], 64)
    (t_out["loss_rpn_cls"] + 2.0 * t_out["loss_rpn_loc"]).backward()
    for k in t_out:
        np.testing.assert_allclose(float(t_out[k].detach()), float(j_out[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(tl.grad), np.asarray(j_grads[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(td.grad), np.asarray(j_grads[1]), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# box head: sampling, losses, inference
# --------------------------------------------------------------------------


def _roi_draws(key, b, n):
    """The uniforms JAX's sample_proposals_batch draws (fast_rcnn.py:124-135)."""
    pri = [[np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(ki)]
           for ki in jax.random.split(key, b)]
    return _t(np.asarray(pri, np.float32))


@pytest.mark.parametrize("append_gt", [True, False])
def test_sample_proposals_matches_jax(append_gt):
    rng = np.random.default_rng(4)
    b, p, m, num_classes = 3, 60, 5, 3
    gt = _random_boxes(rng, (b, m), min_wh=20.0, max_wh=80.0)
    mask = np.zeros((b, m), bool)
    mask[0, :3] = True
    mask[1, :5] = True  # image 2 has no gt
    classes = rng.integers(0, num_classes, (b, m)).astype(np.int32)
    std = rng.normal(size=(b, m, 4)).astype(np.float32)
    jg, tg = _instances(gt, mask, classes=classes, scores=rng.random((b, m)).astype(np.float32),
                        box_std=std)
    # proposals jittered around the gts so that positives exist
    props = np.repeat(gt, p // m, axis=1) + rng.normal(0, 6, (b, p, 4)).astype(np.float32)
    pmask = rng.random((b, p)) < 0.9
    key = jax.random.PRNGKey(9)
    n = p + (m if append_gt else 0)
    got = TF.sample_proposals(_t(props), _t(pmask), tg, 32, 0.25, num_classes, _roi_draws(key, b, n),
                              append_gt=append_gt)
    ref = jax.jit(lambda pb, pm, g: JF.sample_proposals_batch(pb, pm, g, 32, 0.25, num_classes, key,
                                                              append_gt=append_gt))(
        jnp.asarray(props), jnp.asarray(pmask), jg)
    for k in ref:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]), err_msg=k)
    assert 0 < int(got["is_fg"].sum()) <= b * 8


def _loss_inputs(seed, n=40):
    rng = np.random.default_rng(seed)
    props = _random_boxes(rng, (n,), min_wh=10.0, max_wh=60.0)
    gt = props + rng.normal(0, 4, (n, 4)).astype(np.float32)
    return {
        "scores": rng.normal(0, 2, (n, 4)).astype(np.float32),
        "classes": rng.integers(0, 4, n),
        "valid": rng.random(n) < 0.8,
        "is_fg": rng.random(n) < 0.4,
        "props": props, "gt": gt,
        "deltas": rng.normal(0, 0.2, (n, 4)).astype(np.float32),
        "std": rng.normal(0, 2, (n, 4)).astype(np.float32),
        "gt_std": rng.normal(-1, 2, (n, 4)).astype(np.float32),
        "confid": rng.random(n).astype(np.float32),
    }


def _loss_call(mod, name, d, scores, deltas, std, lib):
    b2b = (JXYXY if lib is jnp else Box2BoxXYXYTransform)((10.0, 10.0, 5.0, 5.0))
    a = {k: (jnp.asarray(v) if lib is jnp else _t(v)) for k, v in d.items()}
    fg, valid = a["is_fg"], a["valid"]
    if name == "focal":
        return mod.focal_ce_loss(scores, a["classes"], valid)
    if name == "focal_confid":
        return mod.focal_ce_loss(scores, a["classes"], valid, confid=a["confid"])
    if name == "cross_entropy":
        return mod.cross_entropy_loss(scores, a["classes"], valid)
    if name == "smooth_l1":
        return mod.box_reg_loss_smooth_l1(a["props"], a["gt"], deltas, fg, valid, b2b)
    if name == "nlloss":
        return mod.box_reg_loss_nll(a["props"], a["gt"], deltas, std, fg, valid, b2b)
    return mod.box_reg_pseudo_loss_tsbetter(a["props"], a["gt"], deltas, std, a["gt_std"], fg, valid,
                                            b2b, 0.1, 0.5)


@pytest.mark.parametrize("name", ["focal", "focal_confid", "cross_entropy", "smooth_l1", "nlloss",
                                  "tsbetter"])
def test_box_head_losses_and_gradients_match_jax(name):
    d = _loss_inputs(7)
    (j_val, j_grads) = jax.jit(jax.value_and_grad(
        lambda s, de, st: _loss_call(JF, name, d, s, de, st, jnp), argnums=(0, 1, 2)))(
        jnp.asarray(d["scores"]), jnp.asarray(d["deltas"]), jnp.asarray(d["std"]))
    ts, tde, tst = (_t(d[k]).requires_grad_(True) for k in ("scores", "deltas", "std"))
    val = _loss_call(TF, name, d, ts, tde, tst, torch)
    val.backward()
    assert float(val.detach()) > 0
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    for t, j in zip((ts, tde, tst), j_grads):
        g = np.zeros(t.shape, np.float32) if t.grad is None else _np(t.grad)
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-5, atol=1e-6)


def test_focal_ce_clamps_negative_ce():
    """A confidently right row whose log_softmax rounds a hair positive gives
    0, not NaN (the ce >= 0 clamp)."""
    scores = torch.tensor([[40.0, -40.0, -40.0]])
    loss = TF.focal_ce_loss(scores, torch.tensor([0]), torch.tensor([True]))
    assert torch.isfinite(loss) and float(loss) == 0.0


def test_fast_rcnn_inference_matches_jax():
    rng = np.random.default_rng(8)
    b, p, k = 2, 50, 3
    props = _random_boxes(rng, (b, p), w=120, h=80, min_wh=10.0, max_wh=60.0)
    pmask = rng.random((b, p)) < 0.9
    scores = rng.normal(0, 1.5, (b, p, k + 1)).astype(np.float32)
    deltas = rng.normal(0, 0.1, (b, p, 4)).astype(np.float32)
    std = rng.normal(0, 1, (b, p, 4)).astype(np.float32)
    hw = np.asarray([[100, 150], [90, 120]], np.float32)
    args = (0.05, 0.5, 20)
    got = TF.fast_rcnn_inference(_t(props), _t(pmask), _t(scores), _t(deltas), _t(std), _t(hw),
                                 Box2BoxXYXYTransform((10.0, 10.0, 5.0, 5.0)), *args, total_candidates=100)
    ref = jax.jit(lambda *xs: JF.fast_rcnn_inference(*xs, JXYXY((10.0, 10.0, 5.0, 5.0)), *args,
                                                     total_candidates=100))(
        jnp.asarray(props), jnp.asarray(pmask), jnp.asarray(scores), jnp.asarray(deltas),
        jnp.asarray(std), jnp.asarray(hw))
    np.testing.assert_array_equal(_np(got.mask), np.asarray(ref.mask))
    assert int(got.mask.sum()) > 0
    np.testing.assert_array_equal(_np(got.classes), np.asarray(ref.classes))
    for k in ("boxes", "scores", "cls_confid", "box_std"):
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(ref, k)), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    assert (_np(got.num_candidates) >= _np(got.mask).sum(-1)).all()


# --------------------------------------------------------------------------
# the detector's stages and its inference function
# --------------------------------------------------------------------------


def test_params_from_jax_carries_the_rcnn_tree():
    """A full JAX TwoStageRCNN init loads strictly (4-d conv kernels, the
    RPN's (1, 1, C, n) kernels, 2-d Dense kernels), and features / rpn /
    roi_box agree with the JAX module's."""
    from ubteacher_tpu_torch.checkpoint import params_from_jax

    jcfg, tcfg = small_rcnn_cfgs()
    jmodel, params = jax_rcnn_model_and_params(jcfg, seed=RCNN_SEED)
    sd = params_from_jax(params)
    assert sd["box_head.fc1.weight"].shape == (1024, 7 * 7 * 256)
    assert sd["rpn_head.objectness_logits.weight"].shape == (3, 256, 1, 1)
    model = port_rcnn_model(tcfg, params)

    rng = np.random.default_rng(3)
    images = rng.normal(110, 40, (RCNN_B, *RCNN_CANVAS, 3)).clip(0, 255).astype(np.float32)
    hw = np.asarray([[64, 64], [50, 40]], np.float32)
    boxes = np.asarray([[[4, 4, 40, 30], [10, 20, 63, 60], [0, 0, 8, 8]],
                        [[5, 5, 45, 35], [30, 2, 40, 20], [1, 1, 60, 60]]], np.float32)

    @jax.jit
    def stages(p, im, hw_, bx):
        v = {"params": p}
        pyr = jmodel.apply(v, im, hw_, method=jmodel.features)
        return pyr, jmodel.apply(v, pyr, method=jmodel.rpn), jmodel.apply(v, pyr, bx, method=jmodel.roi_box)

    j_pyr, (j_lo, j_de), j_box = stages(jax.tree.map(jnp.asarray, params), jnp.asarray(images),
                                        jnp.asarray(hw), jnp.asarray(boxes))
    with torch.no_grad():
        pyr = model.features(torch.from_numpy(images), torch.from_numpy(hw))
        lo, de = model.rpn(pyr)
        box = model.roi_box(pyr, torch.from_numpy(boxes))
    assert sorted(pyr) == sorted(j_pyr) == ["p2", "p3", "p4", "p5", "p6"]
    pairs = [(pyr[k].permute(0, 2, 3, 1), j_pyr[k], k) for k in pyr]
    pairs += [(lo, j_lo, "objectness"), (de, j_de, "anchor deltas")]
    pairs += [(g, r, f"roi_box {i}") for i, (g, r) in enumerate(zip(box, j_box))]
    for got, ref, what in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=what)


@pytest.mark.parametrize("canvas,hw", [(RCNN_CANVAS, [[64, 64], [56, 48]]), ((96, 64), [[96, 64], [96, 64]])])
def test_inference_fn_matches_jax(canvas, hw):
    """make_rcnn_inference_fn (proposals at test settings, the box head,
    fast_rcnn_inference) and, on its detections, the mutual step's pseudo
    labels (threshold_pseudo_labels at BBOX_THRESHOLD into MAX_PSEUDO
    slots): the teacher branch of the mutual step."""
    from ubteacher_tpu.engine.rcnn_trainer import make_rcnn_inference_fn as j_make
    from ubteacher_tpu.modeling.fcos_outputs import threshold_pseudo_labels as j_threshold
    from ubteacher_tpu_torch.engine.rcnn_trainer import make_rcnn_inference_fn
    from ubteacher_tpu_torch.modeling.fcos_outputs import threshold_pseudo_labels

    jcfg, tcfg, jmodel, params, jbatch, tbatch = rcnn_setup(canvas)
    hw = np.asarray(hw, np.float32)
    ref = j_make(jcfg, jmodel)(jax.tree.map(jnp.asarray, params), jbatch["images_unlabel_k"], jnp.asarray(hw))
    got = make_rcnn_inference_fn(tcfg)(port_rcnn_model(tcfg, params), tbatch["images_unlabel_k"],
                                       torch.from_numpy(hw))
    thresh, cap = tcfg.SEMISUPNET.BBOX_THRESHOLD, tcfg.TPU.MAX_PSEUDO
    pairs = [(got, ref), (threshold_pseudo_labels(got, thresh, cap), j_threshold(ref, thresh, cap))]
    for t, j in pairs:
        np.testing.assert_array_equal(_np(t.mask), np.asarray(j.mask))
        assert int(t.mask.sum()) > 0
        np.testing.assert_array_equal(_np(t.classes), np.asarray(j.classes))
        for k in ("boxes", "scores", "box_std"):
            np.testing.assert_allclose(_np(getattr(t, k)), np.asarray(getattr(j, k)), rtol=1e-4,
                                       atol=DET_ATOL[k], err_msg=k)


# --------------------------------------------------------------------------
# the CUDA launchers
# --------------------------------------------------------------------------


def test_new_kernel_launchers_refuse_cpu_tensors():
    """The launchers raise on CPU tensors and count nothing; the wrappers
    route CPU tensors to the plain versions."""
    mods = (matcher_cuda, roi_align_cuda, row_scatter_cuda)
    before = [dict(m.LAUNCHES) for m in mods]
    with pytest.raises(ValueError):
        matcher_cuda.match_anchors_kernel(torch.zeros((8, 4)), torch.zeros((1, 2, 4)),
                                          torch.ones((1, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        roi_align_cuda.roi_align_forward_kernel([torch.zeros((1, 2, 8, 8))], torch.zeros((3, 4)),
                                                torch.zeros(3, dtype=torch.int32), 3, [0.25], 7, 0)
    with pytest.raises(ValueError):
        roi_align_cuda.roi_align_backward_kernel(torch.zeros((3, 7, 7, 2)), [torch.zeros((1, 2, 8, 8))],
                                                 torch.zeros((3, 4)), torch.zeros(3, dtype=torch.int32), 3, [0.25], 7, 0)
    with pytest.raises(ValueError):
        row_scatter_cuda.scatter_rows_kernel(torch.zeros((1, 2, 3)), torch.zeros((1, 2), dtype=torch.long), 4)
    out = row_scatter_cuda.scatter_rows(torch.ones((1, 2, 3)), torch.tensor([[1, 1]]), 4)
    assert out[0, 1].tolist() == [2.0, 2.0, 2.0]
    assert [dict(m.LAUNCHES) for m in mods] == before
