"""The port's solver and EMA against ubteacher_tpu's: LR schedules, the
freeze mask, per-parameter weight decay / LR factor, three SGD updates from
the same gradients, and the EMA teacher update. All float32 on the CPU, same
formulas: updates agree to 1e-4 of their size plus a few ulps of the
parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    jax_model_and_params,
    port_model,
    small_cfgs,
    tmp_budget,
)
from ubteacher_tpu.engine.fcos_trainer import _ema_update as j_ema_update
from ubteacher_tpu.solver import build as JS
from ubteacher_tpu_torch.checkpoint import params_from_jax
from ubteacher_tpu_torch.engine.fcos_trainer import _ema_update
from ubteacher_tpu_torch.solver import build as TS


def _flat_names(tree, path=()):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat_names(v, path + (k,)))
        return out
    return {path: tree}


def _port_name(path):
    """Flax path -> the port's parameter name (params_from_jax's rule)."""
    parts = [p for p in path[:-1] if p != "GroupNorm_0"]
    leaf = path[-1]
    if leaf == "kernel" or ("GroupNorm_0" in path and leaf == "scale"):
        leaf = "weight"
    return ".".join(parts + [leaf])


@pytest.mark.parametrize("opts", [
    [],
    ["SOLVER.LR_SCHEDULER_NAME", "WarmupTwoStageMultiStepLR", "SOLVER.STEPS", "(5, 9)",
     "SOLVER.FACTOR_LIST", "(1, 0.3, 0.1)", "SOLVER.WARMUP_METHOD", "constant", "SOLVER.WARMUP_ITERS", "4"],
    ["SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR", "SOLVER.MAX_ITER", "20", "SOLVER.WARMUP_ITERS", "3"],
])
def test_lr_schedules_match_jax(opts):
    jcfg, tcfg = small_cfgs(opts + (["SOLVER.STEPS", "(6,)", "SOLVER.WARMUP_ITERS", "4"] if not opts else []))
    jsched, tsched = JS.build_lr_schedule(jcfg), TS.build_lr_schedule(tcfg)
    for step in range(14):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6, err_msg=str(step))


def test_freeze_mask_and_hyperparams_match_jax():
    jcfg, tcfg = small_cfgs(["SOLVER.BIAS_LR_FACTOR", "2.0", "SOLVER.WEIGHT_DECAY_NORM", "0.5"])
    _, params = jax_model_and_params(jcfg)
    model = port_model(tcfg, params)
    jmask = _flat_names(JS.trainable_mask(params, 2))
    jdecay, jlr = (_flat_names(t) for t in JS.optimizer_hyperparams(jcfg, params))
    tmask = TS.trainable_mask(model, 2)
    assert set(tmask) == {_port_name(p) for p in jmask}
    for path, trainable in jmask.items():
        name = _port_name(path)
        assert tmask[name] == trainable, name
        assert TS.optimizer_hyperparams(tcfg, name) == (jdecay[path], jlr[path]), name


@pytest.mark.parametrize("clip", [
    [],
    ["SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.01"],
    ["SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
     "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5"],
])
def test_sgd_updates_match_optax(clip):
    opts = ["SOLVER.BASE_LR", "0.1", "SOLVER.WARMUP_ITERS", "2", "SOLVER.BIAS_LR_FACTOR", "2.0",
            "SOLVER.WEIGHT_DECAY", "0.01"] + clip
    jcfg, tcfg = small_cfgs(opts)
    _, params = jax_model_and_params(jcfg)
    model = port_model(tcfg, params)
    opt = TS.build_optimizer(tcfg, model)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = JS.build_optimizer(jcfg, jparams)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(0)
    mask = JS.trainable_mask(params, 2)
    for _ in range(3):
        # frozen parameters get zero gradients, as stop_frozen_gradients
        # gives them in the JAX step (the global clip norm sees them)
        grads = jax.tree.map(
            lambda p, m: jnp.asarray(rng.normal(0, 0.1, p.shape) * m, jnp.float32), jparams, mask)
        updates, opt_state = update(grads, opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tgrads = params_from_jax(jax.tree.map(np.asarray, grads))
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone() if p.requires_grad else None
        opt.step()
    ref = params_from_jax(jax.tree.map(np.asarray, jparams))
    init = params_from_jax(params)
    for name, p in model.named_parameters():
        # the updates agree to 1e-4 of their size (the clip's global norm is
        # a float32 sum of ~10^6 squares, taken in another order), plus a few
        # float32 ulps of the parameter they are added to
        want = (ref[name] - init[name]).numpy()
        atol = 1e-4 * np.abs(want).max() + 4 * np.spacing(np.abs(ref[name].numpy()).max())
        np.testing.assert_allclose((p.detach() - init[name]).numpy(), want, rtol=0, atol=atol,
                                   err_msg=name)


def test_ema_update_matches_jax():
    jcfg, tcfg = small_cfgs()
    _, params = jax_model_and_params(jcfg, seed=0)
    _, params2 = jax_model_and_params(jcfg, seed=1)
    teacher, student = port_model(tcfg, params), port_model(tcfg, params2)
    ref = j_ema_update(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, params2),
                       jnp.float32(0.9999))
    _ema_update(teacher, student, 0.9999)
    got = teacher.state_dict()
    for name, want in params_from_jax(jax.tree.map(np.asarray, ref)).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-7, atol=0, err_msg=name)
