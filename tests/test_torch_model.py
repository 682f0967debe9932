"""Backbone + FPN + FCOS head of the port against the JAX model, with the
JAX parameters carried over by params_from_jax. Both run in float32 on the
CPU; the tolerance is the one tests/test_torch_equivalence.py uses for the
same graph (float32 convolutions summed in another order by XLA and by
PyTorch's CPU kernels)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    CANVAS,
    jax_model_and_params,
    port_model,
    small_cfgs,
    small_rcnn_cfgs,
    tmp_budget,
)


def test_fcos_model_matches_jax():
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_model_and_params(jcfg, seed=3)
    rng = np.random.default_rng(11)
    # nontrivial FrozenBN affines and head biases
    for stage in ("res3_block0", "res4_block1"):
        for norm in ("conv1_norm", "conv2_norm", "conv3_norm"):
            leaf = params["backbone"][stage][norm]
            leaf["scale"] = rng.normal(1.0, 0.1, leaf["scale"].shape).astype(np.float32)
            leaf["bias"] = rng.normal(0.0, 0.1, leaf["bias"].shape).astype(np.float32)
    for name in ("bbox_pred", "ctrness", "bbox_pred_std", "cls_conv1"):
        leaf = params["head"][name]
        leaf["bias"] = rng.normal(0.0, 0.05, leaf["bias"].shape).astype(np.float32)
    params["head"]["scales"] = np.asarray([1.0, 0.9, 1.1, 1.2, 0.8], np.float32)
    tmodel = port_model(tcfg, params)

    h, w = CANVAS
    images = rng.normal(110, 40, (2, h, w, 3)).clip(0, 255).astype(np.float32)
    hw = np.asarray([[h, w], [48, 70]], np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(images), jnp.asarray(hw))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), torch.from_numpy(hw))
    for name in ("logits", "reg", "ctrness", "reg_std"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-3, atol=5e-3, err_msg=name,
        )


@pytest.mark.parametrize("kind", ["fcos", "rcnn"])
def test_build_functions_default_to_the_card(kind, monkeypatch):
    """With no device the build functions build on the card, and raise where
    there is none rather than building on the CPU; the geometry helpers
    default to the card too."""
    from ubteacher_tpu_torch.modeling.anchors import generate_anchors
    from ubteacher_tpu_torch.modeling.fcos_head import build_one_stage_detector
    from ubteacher_tpu_torch.modeling.fcos_outputs import compute_locations
    from ubteacher_tpu_torch.modeling.rcnn import build_two_stage_rcnn

    build, cfg = {"fcos": (build_one_stage_detector, small_cfgs()[1]),
                  "rcnn": (build_two_stage_rcnn, small_rcnn_cfgs()[1])}[kind]
    for fn in (build, generate_anchors, compute_locations):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    assert next(build(cfg, device="cpu").parameters()).device.type == "cpu"
