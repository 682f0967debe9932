"""The slice end to end: one burnin_step and one mutual_step of the port
against ubteacher_tpu's, from the same weights (carried over by
params_from_jax) and the same batch, with the port fed the strong-augmentation
draws the JAX step makes (its key splits replayed under the
jax_threefry_partitionable setting of conftest.py).

Tolerances, and why:
  * The JAX strong augmentation runs in bfloat16 (augment.py:379 casts the
    image, and the blur's band matmuls are bf16, :335-340); the port applies
    the same draws in float32. The student's strong images therefore differ
    by up to a few bf16 ulps of a [0, 1] pixel (a few units of 255), so
    losses and gradients that see strong images agree to rtol 2e-3, not to
    float32 precision. Weak-image paths (the teacher, the pseudo labels) see
    identical inputs and agree to float32 convolution order (rtol 1e-4).
  * Parameters move by lr * (grad + wd * param) with lr = 1e-5 at update 0,
    so the updates, not the parameters, are compared (see _compare_params).
  * The cls_logits bias is raised so the random-init teacher scores pass
    INFERENCE_TH_TRAIN; seed and bias are chosen so that every pseudo-box
    score, NMS overlap and top-k cut lies clear of its threshold, so the
    hard cuts do not flip on ulps and the pseudo counts match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    CANVAS,
    jax_instances,
    jax_model_and_params,
    jax_strong_draws,
    port_instances,
    port_model,
    small_cfgs,
    synthetic_batch,
    tmp_budget,
)

B = 2
SEED = 0
CLS_BIAS = 0.5
RNG_KEY = 7


def _setup():
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_model_and_params(jcfg, seed=SEED, cls_bias=np.full(4, CLS_BIAS))
    images_l, boxes, classes, mask = synthetic_batch(SEED + 100, B, 4, jcfg.TPU.MAX_GT)
    images_u, _, _, _ = synthetic_batch(SEED + 200, B, 4, jcfg.TPU.MAX_GT)
    jbatch = {
        "images_label_k": jnp.asarray(images_l),
        "gt_label": jax_instances(boxes, classes, mask),
        "images_unlabel_k": jnp.asarray(images_u),
        "rng": jax.random.PRNGKey(RNG_KEY),
    }
    tbatch = {
        "images_label_k": torch.from_numpy(images_l),
        "gt_label": port_instances(boxes, classes, mask),
        "images_unlabel_k": torch.from_numpy(images_u),
    }
    return jcfg, tcfg, jmodel, params, jbatch, tbatch


def _jax_step(jcfg, jmodel, params, jbatch, which, step):
    from ubteacher_tpu.engine import FCOSTrainState, make_fcos_train_steps
    from ubteacher_tpu.solver import build_optimizer

    jparams = jax.tree.map(jnp.asarray, params)
    tx = build_optimizer(jcfg, jparams)
    burnin, mutual = make_fcos_train_steps(jcfg, jmodel, tx)
    state = FCOSTrainState.create(jparams, tx).replace(step=jnp.asarray(step, jnp.int32))
    new_state, metrics = (burnin if which == "burnin" else mutual)(state, jbatch)
    to_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
    return to_np(new_state.student), to_np(new_state.teacher), {
        k: float(v) for k, v in jax.device_get(metrics).items()
    }


def _port_step(tcfg, params, tbatch, which, step):
    from ubteacher_tpu_torch.engine import FCOSTrainState, make_fcos_train_steps
    from ubteacher_tpu_torch.solver import build_optimizer

    model = port_model(tcfg, params)
    state = FCOSTrainState.create(model, build_optimizer(tcfg, model))
    state.step = step
    burnin, mutual = make_fcos_train_steps(tcfg)
    state, metrics = (burnin if which == "burnin" else mutual)(state, tbatch)
    return state, {k: float(v) for k, v in metrics.items()}


def _compare_params(port_module, jax_tree, init_tree, what):
    """Updates (new - initial) of every parameter: equal where JAX leaves a
    parameter untouched (frozen), within 2e-2 of the update's norm over the
    whole model, 1e-2 per tensor for the head's output convolutions, and
    5e-1 per tensor elsewhere. Measured on this batch: 7e-3 over the model;
    up to 2e-1 in tensors whose gradients are sums of strongly cancelling
    terms (GroupNorm scales, the 1x1 P6/P7 levels, deep res5 convs of the
    random-init backbone), 6e-2 for those even when both sides get the
    same strong images."""
    from ubteacher_tpu_torch.checkpoint import params_from_jax

    ref = params_from_jax(jax_tree)
    init = params_from_jax(init_tree)
    got = port_module.state_dict()
    assert set(ref) == set(got), what
    num = den = 0.0
    for name, r in ref.items():
        dj = r.double() - init[name].double()
        dt = got[name].double() - init[name].double()
        if not dj.any():
            assert not dt.any(), f"{what} {name} moved"
            continue
        err = float((dt - dj).norm() / dj.norm())
        head_out = name.startswith(("head.cls_logits", "head.bbox_pred", "head.ctrness"))
        assert err < (1e-2 if head_out else 5e-1), f"{what} {name}: {err}"
        num += float((dt - dj).norm() ** 2)
        den += float(dj.norm() ** 2)
    assert den > 0, f"{what}: nothing moved"
    assert (num / den) ** 0.5 < 2e-2, f"{what}: {(num / den) ** 0.5}"


def _compare_metrics(port, ref, rtol):
    for k, v in ref.items():
        np.testing.assert_allclose(port[k], v, rtol=rtol, atol=1e-5, err_msg=k)


def test_burnin_step_matches_jax():
    jcfg, tcfg, jmodel, params, jbatch, tbatch = _setup()
    h, w = CANVAS
    j_student, _, j_metrics = _jax_step(jcfg, jmodel, params, jbatch, "burnin", 0)
    tbatch["strong_label"] = jax_strong_draws(jbatch["rng"], B, h, w)
    state, t_metrics = _port_step(tcfg, params, tbatch, "burnin", 0)
    assert state.step == 1
    _compare_metrics(t_metrics, j_metrics, rtol=2e-3)
    _compare_params(state.student, j_student, params, "student")


def test_mutual_step_matches_jax():
    jcfg, tcfg, jmodel, params, jbatch, tbatch = _setup()
    h, w = CANVAS
    burn_up = jcfg.SEMISUPNET.BURN_UP_STEP
    j_student, j_teacher, j_metrics = _jax_step(jcfg, jmodel, params, jbatch, "mutual", burn_up)
    k_label, k_unlabel = jax.random.split(jbatch["rng"])
    tbatch["strong_label"] = jax_strong_draws(k_label, B, h, w)
    tbatch["strong_unlabel"] = jax_strong_draws(k_unlabel, B, h, w)
    state, t_metrics = _port_step(tcfg, params, tbatch, "mutual", burn_up)

    assert j_metrics["num_pseudo_cls"] > 0 and j_metrics["num_pseudo_reg"] > 0
    for k in ("num_pseudo_cls", "num_pseudo_reg", "ema_rate_1000x"):
        assert t_metrics[k] == j_metrics[k], k
    assert t_metrics["num_nms_candidates"] > 0
    _compare_metrics(t_metrics, j_metrics, rtol=2e-3)
    # at the burn-in boundary the teacher is an exact copy of the student
    from ubteacher_tpu_torch.checkpoint import params_from_jax

    got_teacher = state.teacher.state_dict()
    for name, ref in params_from_jax(j_teacher).items():
        np.testing.assert_array_equal(got_teacher[name].numpy(), ref.numpy(), err_msg=name)
    _compare_params(state.student, j_student, params, "student")


def test_oracle_pseudo_uses_unlabeled_ground_truth():
    """TPU.ORACLE_PSEUDO: both pseudo sets are the unlabeled stream's ground
    truth, and the teacher's decode (and its NMS) does not run."""
    from ubteacher_tpu_torch.engine import FCOSTrainState, make_fcos_train_steps
    from ubteacher_tpu_torch.solver import build_optimizer

    _, tcfg = small_cfgs(["TPU.ORACLE_PSEUDO", "True"])
    _, params = jax_model_and_params(small_cfgs()[0], seed=SEED)
    images_l, boxes, classes, mask = synthetic_batch(SEED + 100, B, 4, tcfg.TPU.MAX_GT)
    model = port_model(tcfg, params)
    state = FCOSTrainState.create(model, build_optimizer(tcfg, model))
    state.step = tcfg.SEMISUPNET.BURN_UP_STEP
    _, mutual = make_fcos_train_steps(tcfg)
    batch = {
        "images_label_k": torch.from_numpy(images_l),
        "gt_label": port_instances(boxes, classes, mask),
        "images_unlabel_k": torch.from_numpy(images_l),
        "gt_unlabel": port_instances(boxes, classes, mask),
        "rng": torch.Generator().manual_seed(0),
    }
    _, metrics = mutual(state, batch)
    assert int(metrics["num_pseudo_cls"]) == int(metrics["num_pseudo_reg"]) == int(mask.sum())
    assert int(metrics["num_nms_candidates"]) == 0
    assert all(torch.isfinite(v).all() for v in metrics.values())
