"""Shared helpers of the test_torch_* parity tests: the same small FCOS
configuration in both packages, the JAX model with its parameters carried
into the port through params_from_jax, seeded synthetic batches, and a replay
of the JAX strong augmentation's key splits as port draws."""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

CFG_PATH = os.path.join(
    os.path.dirname(__file__), "..", "configs", "FCOS", "coco-standard",
    "fcos_R_50_ut2_sup1_run0.yaml",
)

# small size of tests/test_sharding_equivalence.py: depth 18, 4 classes,
# float32, small MAX_GT / NMS_CANDIDATES, a 64x96 canvas
SMALL_OPTS = [
    "MODEL.RESNETS.DEPTH", "18",
    "MODEL.FCOS.NUM_CLASSES", "4",
    "TPU.COMPUTE_DTYPE", "float32",
    "TPU.MAX_GT", "4",
    "TPU.MAX_PSEUDO", "10",
    "TPU.NMS_CANDIDATES", "50",
    "SEMISUPNET.BURN_UP_STEP", "100",
]
CANVAS = (64, 96)


def small_cfgs(extra_opts=()):
    """(JAX cfg, port cfg) of the shipped FCOS recipe cut to test size."""
    from ubteacher_tpu.config import add_ubteacher_config, get_cfg
    from ubteacher_tpu_torch.config import add_ubteacher_config as t_add, get_cfg as t_get

    out = []
    for get, add in ((get_cfg, add_ubteacher_config), (t_get, t_add)):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(CFG_PATH)
        cfg.merge_from_list(SMALL_OPTS + list(extra_opts))
        cfg.freeze()
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_init(cfg_yaml: str, seed: int):
    from ubteacher_tpu.config import CfgNode
    from ubteacher_tpu.modeling.fcos_head import build_one_stage_detector

    cfg = CfgNode(yaml.safe_load(cfg_yaml))
    model = build_one_stage_detector(cfg)
    h, w = CANVAS
    return model, _numpy_tree(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)))["params"])


def jax_model_and_params(cfg, seed=0, cls_bias=None):
    """JAX detector and float32 numpy params (a fresh copy per call; the
    init is cached per configuration and seed); `cls_bias` overrides the
    cls_logits bias (a random-init teacher otherwise scores nothing)."""
    model, params = _jax_init(cfg.dump(), seed)
    params = _numpy_tree(params)
    if cls_bias is not None:
        params["head"]["cls_logits"]["bias"] = np.asarray(cls_bias, np.float32)
    return model, params


def _numpy_tree(tree):
    """Nested plain dicts of float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def port_model(cfg, params):
    """The port's detector on the CPU with the JAX parameters loaded."""
    from ubteacher_tpu_torch.checkpoint import params_from_jax
    from ubteacher_tpu_torch.modeling.fcos_head import build_one_stage_detector

    model = build_one_stage_detector(cfg)
    missing, unexpected = model.load_state_dict(params_from_jax(params), strict=True)
    assert not missing and not unexpected
    return model


def synthetic_batch(seed, b, num_classes, max_gt):
    """numpy images (B, H, W, 3) in [0, 255] and padded gt with two boxes."""
    h, w = CANVAS
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    classes = rng.integers(0, num_classes, (b, max_gt)).astype(np.int32)
    mask = np.zeros((b, max_gt), bool)
    boxes[:, 0] = [8, 8, 40, 44]
    boxes[:, 1] = [20, 16, 88, 60]
    mask[:, :2] = True
    images = rng.normal(110, 40, (b, h, w, 3)).clip(0, 255).astype(np.float32)
    return images, boxes, classes, mask


def jax_instances(boxes, classes, mask):
    from ubteacher_tpu.structures import PaddedInstances

    b, m = mask.shape
    return PaddedInstances(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.ones((b, m)),
        jnp.zeros((b, m, 4)), jnp.asarray(mask),
    )


def port_instances(boxes, classes, mask):
    from ubteacher_tpu_torch.structures import PaddedInstances

    b, m = mask.shape
    return PaddedInstances(
        torch.from_numpy(boxes), torch.from_numpy(classes).long(),
        torch.ones((b, m)), torch.zeros((b, m, 4)), torch.from_numpy(mask),
    )


def jax_strong_draws(key, b, h, w):
    """The draws `ubteacher_tpu.data.augment.strong_augment(images, key)`
    makes, replayed from its key splits (augment.py:270, 350, 380, 390, 407)
    and returned as the port's StrongAugParams. The jitter factors are the
    bf16-rounded values the JAX pipeline multiplies by; its image turns
    float32 at the grayscale step (bf16 pixels times float32 luma weights,
    augment.py:290-293), so the erasing noise is drawn in float32."""
    from ubteacher_tpu_torch.data.augment import ERASE_PASSES, StrongAugParams

    def u(k, lo, hi):
        return float(jax.random.uniform(k, (), minval=lo, maxval=hi).astype(jnp.bfloat16))

    fields = {k: [] for k in ("jitter", "apply_jitter", "apply_gray", "sigma",
                              "apply_blur", "erase_box", "apply_erase", "erase_noise")}
    for key_i in jax.random.split(key, b):
        k = jax.random.split(key_i, 6)
        kb, kc, ks, kh = jax.random.split(k[0], 4)
        fields["jitter"].append([u(kb, 0.6, 1.4), u(kc, 0.6, 1.4), u(ks, 0.6, 1.4), u(kh, -0.1, 0.1)])
        fields["apply_jitter"].append(bool(jax.random.uniform(k[1], ()) < 0.8))
        fields["apply_gray"].append(bool(jax.random.uniform(k[2], ()) < 0.2))
        fields["sigma"].append(float(jax.random.uniform(k[3], (), minval=0.1, maxval=2.0)))
        fields["apply_blur"].append(bool(jax.random.uniform(k[4], ()) < 0.5))
        boxes, applies, noises = [], [], []
        for ke, (p, scale, ratio) in zip(jax.random.split(k[5], 3), ERASE_PASSES):
            karea, kratio, ky, kx, kval, kp = jax.random.split(ke, 6)
            target = jax.random.uniform(karea, (), minval=scale[0], maxval=scale[1]) * (h * w)
            logr = jax.random.uniform(
                kratio, (), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])
            )
            r = jnp.exp(logr)
            eh = jnp.clip(jnp.sqrt(target * r), 1, h - 1).astype(jnp.int32)
            ew = jnp.clip(jnp.sqrt(target / r), 1, w - 1).astype(jnp.int32)
            y0 = jax.random.randint(ky, (), 0, h - eh)
            x0 = jax.random.randint(kx, (), 0, w - ew)
            boxes.append([int(y0), int(x0), int(eh), int(ew)])
            noises.append(np.asarray(
                jnp.clip(jax.random.normal(kval, (h, w, 3), jnp.float32), 0.0, 1.0),
                np.float32,
            ))
            applies.append(bool(jax.random.uniform(kp, ()) < p))
        fields["erase_box"].append(boxes)
        fields["apply_erase"].append(applies)
        fields["erase_noise"].append(np.stack(noises))
    return StrongAugParams(
        jitter=torch.tensor(fields["jitter"], dtype=torch.float32),
        apply_jitter=torch.tensor(fields["apply_jitter"]),
        apply_gray=torch.tensor(fields["apply_gray"]),
        sigma=torch.tensor(fields["sigma"], dtype=torch.float32),
        apply_blur=torch.tensor(fields["apply_blur"]),
        erase_box=torch.tensor(fields["erase_box"], dtype=torch.long),
        apply_erase=torch.tensor(fields["apply_erase"]),
        erase_noise=torch.from_numpy(np.stack(fields["erase_noise"])),
    )
