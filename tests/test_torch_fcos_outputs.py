"""The port's FCOS outputs (assignment, losses, decoding) against
ubteacher_tpu.modeling.fcos_outputs on the CPU, at the parity tests' small
size (64x96 canvas, 4 classes).

Tolerances: target assignment is exact (labels, masks) or equal to float32
rounding (regression targets, rtol 1e-6). The losses run on fixed dense
outputs and fixed targets, so both sides compute the same float32 formulas in
another order: rtol 1e-5 on values and gradients. Decoding runs on dense
outputs with distinct scores: masks and classes exact, boxes to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    CANVAS,
    jax_instances,
    port_instances,
    small_cfgs,
    tmp_budget,
)
from ubteacher_tpu.modeling import fcos_outputs as J
from ubteacher_tpu_torch.modeling import fcos_outputs as T

STRIDES = [8, 16, 32, 64, 128]
C = 4


def _grids():
    return J.compute_locations(CANVAS, STRIDES), T.compute_locations(CANVAS, STRIDES, device="cpu")


def _gt(seed, b=2, m=6):
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    xy = rng.random((b, m, 2)) * [w * 0.7, h * 0.7]
    wh = rng.random((b, m, 2)) * [w * 0.6, h * 0.6] + 6
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.integers(0, C, (b, m)).astype(np.int32)
    mask = rng.random((b, m)) > 0.3
    mask[1] = False  # an image with no valid gt
    scores = rng.random((b, m)).astype(np.float32)
    std = rng.normal(-2.0, 1.0, (b, m, 4)).astype(np.float32)
    jgt = jax_instances(boxes, classes, mask).replace(
        scores=jnp.asarray(scores), box_std=jnp.asarray(std))
    tgt = port_instances(boxes, classes, mask)
    tgt.scores, tgt.box_std = torch.from_numpy(scores), torch.from_numpy(std)
    return jgt, tgt


def _to_port_targets(jt):
    return T.FCOSTargets(
        labels=torch.from_numpy(np.array(jt.labels)).long(),
        reg_targets=torch.from_numpy(np.array(jt.reg_targets)),
        box_weights=torch.from_numpy(np.array(jt.box_weights)),
        boundary_vars=torch.from_numpy(np.array(jt.boundary_vars)),
        keep=torch.from_numpy(np.array(jt.keep)),
        pos=torch.from_numpy(np.array(jt.pos)),
    )


def test_locations_match_jax():
    jg, tg = _grids()
    for k in jg:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]), err_msg=k)
    hw = np.asarray([[64, 96], [40, 50]], np.float32)
    np.testing.assert_array_equal(
        T.location_validity(tg, torch.from_numpy(hw)).numpy(),
        np.asarray(J.location_validity(jg, jnp.asarray(hw))),
    )


@pytest.mark.parametrize("center_sample,ignore_near", [(False, False), (True, False), (True, True)])
def test_assign_targets_match_jax(center_sample, ignore_near):
    jg, tg = _grids()
    jgt, tgt = _gt(0)
    hw = np.asarray([[64, 96], [48, 80]], np.float32)
    ref = J.fcos_assign_targets(jg, jgt, C, center_sample, 1.5, ignore_near, jnp.asarray(hw))
    got = T.fcos_assign_targets(tg, tgt, C, center_sample, 1.5, ignore_near, torch.from_numpy(hw))
    assert np.asarray(ref.pos).any()
    for k in ("labels", "keep", "pos"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("reg_targets", "box_weights", "boundary_vars"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _dense(seed, b=2, reg_discrete=True):
    rng = np.random.default_rng(seed)
    n = sum(h * w for h, w in J.level_feature_sizes(CANVAS, STRIDES))
    reg_dim = 4 * 17 if reg_discrete else 4
    arrays = {
        "logits": rng.normal(-1.0, 2.0, (b, n, C)),
        "reg": rng.normal(0.0, 2.0, (b, n, reg_dim)) if reg_discrete else rng.random((b, n, 4)) * 6 + 0.1,
        "ctrness": rng.normal(0.0, 1.0, (b, n)),
        "reg_std": rng.normal(0.0, 1.0, (b, n, 4)),
    }
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _fcfg(**overrides):
    jcfg, _ = small_cfgs()
    fcfg = J.fcos_loss_config(jcfg)
    fcfg.update(overrides)
    return fcfg


def _loss_and_grads(dense_np, fn_j, fn_t):
    """Loss dicts of both sides and the gradients of their summed losses
    (teacher_better_student is a count) with respect to the dense outputs."""

    def total(vals):
        return sum(v for k, v in vals.items() if k != "teacher_better_student")

    jd = {k: jnp.asarray(v) for k, v in dense_np.items()}
    jvals = fn_j(J.FCOSDense(**jd))
    jgrads = jax.grad(lambda d: total(fn_j(J.FCOSDense(**d))))(jd)
    td = {k: torch.from_numpy(v).requires_grad_(True) for k, v in dense_np.items()}
    tvals = fn_t(T.FCOSDense(**td))
    total(tvals).backward()
    tgrads = {k: t.grad if t.grad is not None else torch.zeros_like(t) for k, t in td.items()}
    return jvals, jgrads, {k: v.detach() for k, v in tvals.items()}, tgrads


def _compare_losses(jvals, jgrads, tvals, tgrads):
    assert set(jvals) == set(tvals)
    for k in jvals:
        np.testing.assert_allclose(float(tvals[k]), float(jvals[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=f"grad {k}")


@pytest.mark.parametrize("kl_loss_type,loc_loss_type,reg_discrete", [
    ("nlloss", "giou", True),   # the shipped recipe
    ("klloss", "iou", False),
])
def test_supervised_losses_match_jax(kl_loss_type, loc_loss_type, reg_discrete):
    jg, _ = _grids()
    jgt, _ = _gt(1)
    hw = np.asarray([[64, 96], [48, 80]], np.float32)
    jt = J.fcos_assign_targets(jg, jgt, C, False, 1.5, image_hw=jnp.asarray(hw))
    tt = _to_port_targets(jt)
    fcfg = _fcfg(kl_loss_type=kl_loss_type, loc_loss_type=loc_loss_type,
                 reg_discrete=reg_discrete, loc_fun_all="weight_ctr_mean")
    dense = _dense(2, reg_discrete=reg_discrete)
    _compare_losses(*_loss_and_grads(
        dense,
        lambda d: J.fcos_supervised_losses(d, jt, fcfg),
        lambda d: T.fcos_supervised_losses(d, tt, fcfg),
    ))


@pytest.mark.parametrize("consist_reg_loss", ["ts_locvar_better_nms_nll_l1", "mse_loss_all_raw"])
def test_pseudo_losses_match_jax(consist_reg_loss):
    jg, _ = _grids()
    jgt_cls, _ = _gt(3)
    jgt_reg, _ = _gt(4)
    jt_cls = J.fcos_assign_targets(jg, jgt_cls, C, False, 1.5)
    jt_reg = J.fcos_assign_targets(jg, jgt_reg, C, False, 1.5)
    fcfg = _fcfg()
    dense = _dense(5)
    jvals, jgrads, tvals, tgrads = _loss_and_grads(
        dense,
        lambda d: J.fcos_pseudo_losses(d, jt_cls, jt_reg, fcfg, 0.1, 0.5, consist_reg_loss),
        lambda d: T.fcos_pseudo_losses(d, _to_port_targets(jt_cls), _to_port_targets(jt_reg),
                                       fcfg, 0.1, 0.5, consist_reg_loss),
    )
    if consist_reg_loss == "ts_locvar_better_nms_nll_l1":
        assert float(jvals["teacher_better_student"]) > 0  # the L1 gate selects something
    _compare_losses(jvals, jgrads, tvals, tgrads)


@pytest.mark.parametrize("nms_method", ["cls", "cls_n_loc", "cls_n_ctr"])
def test_decode_matches_jax(nms_method):
    jg, tg = _grids()
    lengths = [h * w for h, w in J.level_feature_sizes(CANVAS, STRIDES)]
    dense = _dense(6)
    hw = np.asarray([[64, 96], [48, 70]], np.float32)
    fcfg = _fcfg()
    args = dict(nms_method=nms_method, pre_nms_thresh=0.05, pre_nms_topk=40,
                post_nms_topk=15, nms_thresh=0.6, total_candidates=60)
    ref = J.fcos_decode(J.FCOSDense(**{k: jnp.asarray(v) for k, v in dense.items()}),
                        jg, lengths, jnp.asarray(hw), fcfg, **args)
    got = T.fcos_decode(T.FCOSDense(**{k: torch.from_numpy(v) for k, v in dense.items()}),
                        tg, lengths, torch.from_numpy(hw), fcfg, **args)
    mask = np.asarray(ref.mask)
    assert mask.sum() > 10
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.classes.numpy()[mask], np.asarray(ref.classes)[mask])
    np.testing.assert_allclose(got.boxes.numpy()[mask], np.asarray(ref.boxes)[mask], atol=1e-4)
    for k in ("scores", "cls_confid", "centerness", "box_std"):
        np.testing.assert_allclose(getattr(got, k).numpy()[mask], np.asarray(getattr(ref, k))[mask],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(got.num_candidates.min()) > 0

    for jp, tp in (
        (J.threshold_pseudo_labels(ref, 0.5, 10), T.threshold_pseudo_labels(got, 0.5, 10)),
        (J.threshold_pseudo_labels_cls_ctr(ref, 0.5, 0.3, 20),
         T.threshold_pseudo_labels_cls_ctr(got, 0.5, 0.3, 20)),
    ):
        pm = np.asarray(jp.mask)
        np.testing.assert_array_equal(tp.mask.numpy(), pm)
        np.testing.assert_array_equal(tp.classes.numpy()[pm], np.asarray(jp.classes)[pm])
        np.testing.assert_allclose(tp.boxes.numpy()[pm], np.asarray(jp.boxes)[pm], atol=1e-4)
