"""The Faster R-CNN train steps end to end: one burnin_step and one
mutual_step (fused and on mixed canvases) of the port against ubteacher_tpu's,
from the same weights (carried over by params_from_jax), the same batch, and
the port fed the sampling draws the JAX step makes (its key splits replayed
under the jax_threefry_partitionable setting of conftest.py).

The strong augmentation is held out of this comparison: the JAX step's
`strong_augment` is replaced by the identity and the port is given draws
that apply nothing. The JAX augmentation runs in bfloat16 and the port's in
float32 (its parity is tested in test_torch_augment.py and, through the FCOS
step, in test_torch_fcos_trainer.py); here a bf16 ulp in a strong image
would move an RPN top-k or NMS cut and with it the sampled proposals.

The mutual steps run under TPU.ORACLE_PSEUDO (the pseudo set is the batch's
`gt_unlabel`, with teacher-like scores and boundary logits): the teacher's
pseudo boxes differ between the two packages by float32 rounding (about
1e-5 relative), and on border-clipped boxes such a difference can break an
exact IoU tie in the matcher's low-quality promotion and move an RPN sample,
after which the losses differ by a few percent. The teacher branch itself
(proposals at test settings, the box head, fast_rcnn_inference, the
BBOX_THRESHOLD cut) is compared in test_torch_rcnn_ops.py
(test_inference_fn_matches_jax).

Tolerances, and why:
  * Losses: rtol 1e-4; counts of proposals, samples and pseudo boxes equal.
  * Parameters move by lr * (grad + wd * param) with lr = 1e-5 at update 0,
    so the updates are compared: within 1e-3 of the update's norm over the
    whole model and 1e-2 per tensor (measured: below 1e-4 and 3e-3).
"""

import jax
import numpy as np
import pytest

from ubteacher_tpu_torch.ops.kernels import nms_cuda

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    RCNN_B,
    RCNN_CANVAS,
    RCNN_NUM_ANCHORS,
    compare_rcnn_metrics,
    compare_rcnn_updates,
    hold_jax_rcnn_step,
    jax_rcnn_step,
    jax_sampling_draws,
    port_rcnn_step,
    rcnn_setup,
    tmp_budget,
)

B = RCNN_B


@pytest.fixture
def jax_reference(monkeypatch):
    hold_jax_rcnn_step(monkeypatch)


def test_burnin_step_matches_jax(jax_reference):
    jcfg, tcfg, jmodel, params, jbatch, tbatch = rcnn_setup()
    j_student, _, j_metrics = jax_rcnn_step(jcfg, jmodel, params, jbatch, "burnin", 0)
    _, k_branch = jax.random.split(jbatch["rng"])
    n_props = jcfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + jcfg.TPU.MAX_GT
    tbatch["sampling_sup"] = jax_sampling_draws(k_branch, 2 * B, RCNN_NUM_ANCHORS[RCNN_CANVAS], n_props)
    state, t_metrics = port_rcnn_step(tcfg, params, tbatch, "burnin", 0)
    assert state.step == 1
    assert t_metrics["num_roi_fg"] > 0 and t_metrics["num_rpn_samples"] == 2 * B * 64
    compare_rcnn_metrics(t_metrics, j_metrics)
    compare_rcnn_updates(state.student, j_student, params, "student")


@pytest.mark.parametrize("canvas", ["fused", "mixed"])
def test_mutual_step_matches_jax(jax_reference, monkeypatch, canvas):
    fused = canvas == "fused"
    unlabel_hw = RCNN_CANVAS if fused else (96, 64)
    jcfg, tcfg, jmodel, params, jbatch, tbatch = rcnn_setup(unlabel_hw, ("TPU.ORACLE_PSEUDO", "True"))
    burn_up = jcfg.SEMISUPNET.BURN_UP_STEP
    j_student, j_teacher, j_metrics = jax_rcnn_step(jcfg, jmodel, params, jbatch, "mutual", burn_up)
    _, _, k_sup, k_unsup = jax.random.split(jbatch["rng"], 4)
    post = jcfg.MODEL.RPN.POST_NMS_TOPK_TRAIN
    m_gt, m_ps = jcfg.TPU.MAX_GT, jcfg.TPU.MAX_PSEUDO
    if fused:
        tbatch["sampling_sup"] = jax_sampling_draws(
            k_sup, 3 * B, RCNN_NUM_ANCHORS[RCNN_CANVAS], post + max(m_gt, m_ps))
    else:
        tbatch["sampling_sup"] = jax_sampling_draws(k_sup, 2 * B, RCNN_NUM_ANCHORS[RCNN_CANVAS], post + m_gt)
        tbatch["sampling_unsup"] = jax_sampling_draws(k_unsup, B, RCNN_NUM_ANCHORS[unlabel_hw], post + m_ps)
    nms_calls = []
    real_nms = nms_cuda.nms_sorted_keep_plain
    monkeypatch.setattr(nms_cuda, "nms_sorted_keep_plain",
                        lambda *a: nms_calls.append(a[0].shape) or real_nms(*a))
    state, t_metrics = port_rcnn_step(tcfg, params, tbatch, "mutual", burn_up)

    # the oracle pseudo set is the batch's gt_unlabel and the teacher does not
    # run: NMS only for the student's proposals, once per forward
    assert len(nms_calls) == (1 if fused else 2)
    assert t_metrics["num_pseudo"] == int(tbatch["gt_unlabel"].mask.sum()) > 0
    for k in ("num_pseudo", "ema_rate_1000x"):
        assert t_metrics[k] == j_metrics[k], k
    assert t_metrics["loss_box_reg_pseudo"] > 0 or t_metrics["loss_cls_pseudo"] > 0
    compare_rcnn_metrics(t_metrics, j_metrics)
    # at the burn-in boundary the teacher is an exact copy of the student
    from ubteacher_tpu_torch.checkpoint import params_from_jax

    got_teacher = state.teacher.state_dict()
    for name, ref in params_from_jax(j_teacher).items():
        np.testing.assert_array_equal(got_teacher[name].numpy(), ref.numpy(), err_msg=name)
    compare_rcnn_updates(state.student, j_student, params, "student")
