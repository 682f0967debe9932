"""Shared helpers of the test_torch_* parity tests: the same small FCOS and
Faster R-CNN configurations in both packages, the JAX models with their
parameters carried into the port through params_from_jax, seeded synthetic
batches, replays of the JAX package's key splits (strong augmentation,
R-CNN sampling) as port draws, and one R-CNN train step of each package
from one setup."""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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

    model = build_one_stage_detector(cfg, device="cpu")
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


# --------------------------------------------------------------------------
# Faster R-CNN
# --------------------------------------------------------------------------

RCNN_CFG_PATH = os.path.join(
    os.path.dirname(__file__), "..", "configs", "Faster-RCNN", "coco-standard",
    "faster_rcnn_R_50_FPN_ut2_sup1_run0.yaml",
)

# small size of tests/test_rcnn.py (_rcnn_tiny_cfg): depth 18, 3 classes,
# float32, a 64x64 canvas
RCNN_SMALL_OPTS = [
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.RESNETS.DEPTH", "18",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "64",
    "TEST.DETECTIONS_PER_IMAGE", "20",
    "TPU.COMPUTE_DTYPE", "float32",
    "TPU.MAX_GT", "8",
    "TPU.MAX_PSEUDO", "20",
    "TPU.NMS_CANDIDATES", "100",
    "SEMISUPNET.BURN_UP_STEP", "1",
]
RCNN_CANVAS = (64, 64)


def small_rcnn_cfgs(extra_opts=()):
    """(JAX cfg, port cfg) of the shipped Faster R-CNN recipe cut to test
    size."""
    from ubteacher_tpu.config import add_ubteacher_config, get_cfg
    from ubteacher_tpu_torch.config import add_ubteacher_config as t_add, get_cfg as t_get

    out = []
    for get, add in ((get_cfg, add_ubteacher_config), (t_get, t_add)):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(RCNN_CFG_PATH)
        cfg.merge_from_list(RCNN_SMALL_OPTS + list(extra_opts))
        cfg.freeze()
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_rcnn_init(cfg_yaml: str, seed: int):
    from ubteacher_tpu.config import CfgNode
    from ubteacher_tpu.modeling.rcnn import build_two_stage_rcnn

    cfg = CfgNode(yaml.safe_load(cfg_yaml))
    model = build_two_stage_rcnn(cfg)
    h, w = RCNN_CANVAS
    return model, _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)))["params"])


def jax_rcnn_model_and_params(cfg, seed=0, cls_bias=None):
    """JAX TwoStageRCNN and float32 numpy params (a fresh copy per call);
    `cls_bias` overrides the box predictor's cls_score bias (a random-init
    teacher otherwise passes no box through BBOX_THRESHOLD)."""
    model, params = _jax_rcnn_init(cfg.dump(), seed)
    params = _numpy_tree(params)
    if cls_bias is not None:
        params["box_predictor"]["cls_score"]["bias"] = np.asarray(cls_bias, np.float32)
    return model, params


def port_rcnn_model(cfg, params):
    """The port's TwoStageRCNN on the CPU with the JAX parameters loaded."""
    from ubteacher_tpu_torch.checkpoint import params_from_jax
    from ubteacher_tpu_torch.modeling.rcnn import build_two_stage_rcnn

    model = build_two_stage_rcnn(cfg, device="cpu")
    missing, unexpected = model.load_state_dict(params_from_jax(params), strict=True)
    assert not missing and not unexpected
    return model


def jax_sampling_draws(key, b, num_anchors, num_props):
    """The uniforms one JAX R-CNN branch draws from `key`
    (rcnn_trainer.py:141-152): per image, the RPN's positive and negative
    anchor priorities (rpn.py:155-166) and the box head's positive and
    negative proposal priorities (fast_rcnn.py:124-135), as the port's
    SamplingDraws."""
    from ubteacher_tpu_torch.engine.rcnn_trainer import SamplingDraws

    k_anchor, k_sample = jax.random.split(key)

    def draws(k_branch, n):
        return np.asarray([[np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(ki)]
                           for ki in jax.random.split(k_branch, b)], np.float32)

    return SamplingDraws(torch.from_numpy(draws(k_anchor, num_anchors)),
                         torch.from_numpy(draws(k_sample, num_props)))


def identity_strong_draws(b, h, w):
    """StrongAugParams that apply nothing (every apply flag False)."""
    from ubteacher_tpu_torch.data.augment import ERASE_PASSES, StrongAugParams

    n = len(ERASE_PASSES)
    return StrongAugParams(
        jitter=torch.ones((b, 4)), apply_jitter=torch.zeros(b, dtype=torch.bool),
        apply_gray=torch.zeros(b, dtype=torch.bool), sigma=torch.ones(b),
        apply_blur=torch.zeros(b, dtype=torch.bool),
        erase_box=torch.ones((b, n, 4), dtype=torch.long),
        apply_erase=torch.zeros((b, n), dtype=torch.bool),
        erase_noise=torch.zeros((b, n, h, w, 3)),
    )


# --------------------------------------------------------------------------
# Faster R-CNN train steps: both packages from one setup
# --------------------------------------------------------------------------

RCNN_B = 2
RCNN_SEED = 0
RCNN_RNG_KEY = 11
# class 0's cls_score bias: softmax 0.80 against 3 others passes
# BBOX_THRESHOLD 0.7, so a random-init teacher yields pseudo boxes
RCNN_CLS_BIAS = (2.5, 0.0, 0.0, 0.0)
RCNN_NUM_ANCHORS = {(64, 64): 1023, (96, 64): 1536}


def rcnn_batch(seed, b, h, w, max_gt):
    """numpy images in [0, 255] and padded gt: 2 boxes on image 0, 3 on 1,
    with teacher-like scores and boundary logits (for the oracle pseudo
    set)."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    boxes[:, 0] = [6, 8, 40, 38]
    boxes[:, 1] = [24, 20, 60, 58]
    boxes[1, 2] = [2, 30, 22, 62]
    boxes[..., 1::2] *= h / 64.0
    classes = rng.integers(0, 3, (b, max_gt)).astype(np.int32)
    mask = np.zeros((b, max_gt), bool)
    mask[0, :2] = True
    mask[1, :3] = True
    scores = rng.uniform(0.7, 1.0, (b, max_gt)).astype(np.float32)
    box_std = rng.normal(-2.0, 1.5, (b, max_gt, 4)).astype(np.float32)
    images = rng.normal(110, 40, (b, h, w, 3)).clip(0, 255).astype(np.float32)
    return images, (boxes, classes, scores, box_std, mask)


def _both_instances(boxes, classes, scores, box_std, mask):
    from ubteacher_tpu.structures import PaddedInstances as JP
    from ubteacher_tpu_torch.structures import PaddedInstances as TP

    j = JP(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(scores), jnp.asarray(box_std),
           jnp.asarray(mask))
    t = TP(torch.from_numpy(boxes), torch.from_numpy(classes).long(), torch.from_numpy(scores),
           torch.from_numpy(box_std), torch.from_numpy(mask))
    return j, t


def rcnn_setup(unlabel_hw=RCNN_CANVAS, extra_opts=()):
    """(jcfg, tcfg, JAX model, params, JAX batch, port batch). The labeled
    gt has unit scores and zero boundary logits; `gt_unlabel` (used under
    TPU.ORACLE_PSEUDO) has MAX_PSEUDO slots with teacher-like ones. The
    port's batch carries strong draws that apply nothing."""
    jcfg, tcfg = small_rcnn_cfgs(extra_opts)
    jmodel, params = jax_rcnn_model_and_params(jcfg, seed=RCNN_SEED, cls_bias=RCNN_CLS_BIAS)
    b = RCNN_B
    images_l, (boxes, classes, _, _, mask) = rcnn_batch(RCNN_SEED + 100, b, *RCNN_CANVAS, jcfg.TPU.MAX_GT)
    images_u, gt_u = rcnn_batch(RCNN_SEED + 200, b, *unlabel_hw, jcfg.TPU.MAX_PSEUDO)
    ones, zeros = np.ones(mask.shape, np.float32), np.zeros(mask.shape + (4,), np.float32)
    jg, tg = _both_instances(boxes, classes, ones, zeros, mask)
    jgu, tgu = _both_instances(*gt_u)
    jbatch = {
        "images_label_k": jnp.asarray(images_l), "gt_label": jg,
        "images_unlabel_k": jnp.asarray(images_u), "gt_unlabel": jgu,
        "rng": jax.random.PRNGKey(RCNN_RNG_KEY),
    }
    tbatch = {
        "images_label_k": torch.from_numpy(images_l), "gt_label": tg,
        "images_unlabel_k": torch.from_numpy(images_u), "gt_unlabel": tgu,
        "strong_label": identity_strong_draws(b, *RCNN_CANVAS),
        "strong_unlabel": identity_strong_draws(b, *unlabel_hw),
    }
    return jcfg, tcfg, jmodel, params, jbatch, tbatch


def hold_jax_rcnn_step(monkeypatch):
    """The JAX step with the identity for its strong augmentation (the JAX
    augmentation runs in bfloat16, the port's in float32; a bf16 ulp in a
    strong image would move an RPN top-k or NMS cut) and its anchor matcher
    on the XLA formulation (method="xla"): on the CPU its default runs the
    interpreted Pallas matcher, which promotes more anchors than the XLA
    matcher on border-clipped, thin boxes (ROADMAP Queue C); the port's
    matcher is the XLA one, bitwise."""
    import ubteacher_tpu.engine.rcnn_trainer as jrt

    monkeypatch.setattr(jrt, "strong_augment", lambda images, key: images)
    monkeypatch.setattr(jrt, "match_anchors_batched",
                        functools.partial(jrt.match_anchors_batched, method="xla"))


def jax_rcnn_step(jcfg, jmodel, params, jbatch, which, step):
    """One JAX burnin or mutual step -> (student, teacher, metrics)."""
    from ubteacher_tpu.engine import FCOSTrainState
    from ubteacher_tpu.engine.rcnn_trainer import make_rcnn_train_steps
    from ubteacher_tpu.solver import build_optimizer

    jparams = jax.tree.map(jnp.asarray, params)
    tx = build_optimizer(jcfg, jparams)
    burnin, mutual = make_rcnn_train_steps(jcfg, jmodel, tx)
    state = FCOSTrainState.create(jparams, tx).replace(step=jnp.asarray(step, jnp.int32))
    new_state, metrics = (burnin if which == "burnin" else mutual)(state, jbatch)
    to_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
    return to_np(new_state.student), to_np(new_state.teacher), {
        k: float(v) for k, v in jax.device_get(metrics).items()
    }


def port_rcnn_step(tcfg, params, tbatch, which, step):
    """One port burnin or mutual step -> (state, metrics)."""
    from ubteacher_tpu_torch.engine.rcnn_trainer import RCNNTrainState, make_rcnn_train_steps
    from ubteacher_tpu_torch.solver import build_optimizer

    model = port_rcnn_model(tcfg, params)
    state = RCNNTrainState.create(model, build_optimizer(tcfg, model))
    state.step = step
    burnin, mutual = make_rcnn_train_steps(tcfg)
    state, metrics = (burnin if which == "burnin" else mutual)(state, tbatch)
    return state, {k: float(v) for k, v in metrics.items()}


def compare_rcnn_updates(port_module, jax_tree, init_tree, what):
    """Updates (new - initial): equal where JAX leaves a parameter untouched
    (frozen), within 1e-2 of the JAX update's norm per tensor and 1e-3 over
    the whole model."""
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
        assert err < 1e-2, f"{what} {name}: {err}"
        num += float((dt - dj).norm() ** 2)
        den += float(dj.norm() ** 2)
    assert den > 0, f"{what}: nothing moved"
    assert (num / den) ** 0.5 < 1e-3, f"{what}: {(num / den) ** 0.5}"


def compare_rcnn_metrics(port, ref):
    """Every JAX metric (the port adds sample counts of its own)."""
    for k, v in ref.items():
        np.testing.assert_allclose(port[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# Trainers: both packages' training runs on one synthetic COCO set
# --------------------------------------------------------------------------

# the tiny run of tests/test_e2e.py (_tiny_cfg): R-18, float32, 3 classes,
# batches of 2 + 2, burn-in 2 of 4 iterations, square canvases
TRAINER_OPTS = [
    "MODEL.RESNETS.DEPTH", "18",
    "TPU.COMPUTE_DTYPE", "float32",
    "TPU.MAX_GT", "8",
    "TPU.MAX_PSEUDO", "50",
    "TPU.NMS_CANDIDATES", "100",
    "TPU.DATA_THREADS", "2",
    # the JAX trainer on one of the 8 virtual CPU devices: a batch of 2
    # would run replicated on all of them
    "TPU.MESH_DATA", "1",
    "INPUT.MIN_SIZE_TRAIN_SAMPLING", "choice",
    "SOLVER.IMG_PER_BATCH_LABEL", "2",
    "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
    "SOLVER.MAX_ITER", "4",
    "SOLVER.BASE_LR", "0.002",
    "SOLVER.WARMUP_ITERS", "10",
    "SOLVER.CHECKPOINT_PERIOD", "1000",
    "SEMISUPNET.BURN_UP_STEP", "2",
    "TEST.EVAL_PERIOD", "0",
    "MODEL.WEIGHTS", "",
]
# Faster R-CNN on top: the small sizes of tests/test_e2e.py's R-CNN run
TRAINER_RCNN_OPTS = [
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "64",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
    "TEST.DETECTIONS_PER_IMAGE", "20",
]


def canvas_opts(canvas, min_size):
    c = f"({canvas}, {canvas})"
    return ["TPU.CANVAS_LANDSCAPE", c, "TPU.CANVAS_PORTRAIT", c, "TPU.TEST_CANVAS", c,
            "INPUT.MIN_SIZE_TRAIN", f"({min_size},)", "INPUT.MAX_SIZE_TRAIN", str(canvas),
            "INPUT.MIN_SIZE_TEST", str(min_size), "INPUT.MAX_SIZE_TEST", str(canvas)]


def trainer_cfgs(output_dir, rcnn=False, extra_opts=()):
    """(JAX cfg, port cfg) of the tiny trainer run, FCOS or Faster R-CNN."""
    from ubteacher_tpu.config import add_ubteacher_config, get_cfg
    from ubteacher_tpu_torch.config import add_ubteacher_config as t_add, get_cfg as t_get

    if rcnn:
        opts = TRAINER_OPTS + TRAINER_RCNN_OPTS + canvas_opts(64, 48)
    else:
        opts = TRAINER_OPTS + ["MODEL.FCOS.NUM_CLASSES", "3"] + canvas_opts(128, 96)
    out = []
    for get, add, sub in ((get_cfg, add_ubteacher_config, "jax"), (t_get, t_add, "torch")):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(RCNN_CFG_PATH if rcnn else CFG_PATH)
        cfg.merge_from_list(opts + list(extra_opts) + ["OUTPUT_DIR", os.path.join(str(output_dir), sub)])
        cfg.freeze()
        out.append(cfg)
    return tuple(out)


def synthetic_coco(n_images=8, size=96, seed=0):
    """Dataset dicts (xyxy boxes, 3 classes, one crowd box) of colored
    rectangles on noise, and an in-memory reader of their uint8 BGR
    images."""
    rng = np.random.default_rng(seed)
    dicts, arrays = [], {}
    for i in range(n_images):
        img = rng.integers(0, 80, size=(size, size, 3), dtype=np.uint8)
        annos = []
        for j in range(int(rng.integers(1, 4))):
            w, h = int(rng.integers(size // 5, size // 2)), int(rng.integers(size // 5, size // 2))
            x, y = int(rng.integers(0, size - w)), int(rng.integers(0, size - h))
            cat = int(rng.integers(0, 3))
            img[y:y + h, x:x + w] = (60 + 60 * cat, 40 * cat, 255 - 50 * cat)
            annos.append({"bbox": [x, y, x + w, y + h], "category_id": cat, "area": w * h,
                          "iscrowd": int(i == 3 and j == 0)})
        name = f"synthetic/{i}.png"
        arrays[name] = img
        dicts.append({"file_name": name, "image_id": i, "height": size, "width": size, "annotations": annos})
    return dicts, arrays.__getitem__


def trainer_datasets(dicts):
    return {"train": dicts[:6], "train_unlabel": dicts[6:], "test": dicts[:4],
            "meta": {"thing_classes": ["a", "b", "c"]}}


class JaxKeyDraws:
    """The port trainer's loader, each batch carrying the draws the JAX
    trainer's key for that batch makes (PRNGKey(SEED + 17), split once per
    batch): `draws(i, key, batch)` returns the batch keys to add."""

    def __init__(self, loader, draws, seed=0):
        self.loader, self.draws, self.seed = loader, draws, seed

    def __iter__(self):
        key = jax.random.PRNGKey(self.seed + 17)
        for i, batch in enumerate(self.loader):
            key, sub = jax.random.split(key)
            batch.update(self.draws(i, sub, batch))
            yield batch

    def close(self):
        self.loader.close()


def read_metrics(output_dir):
    import json

    with open(os.path.join(output_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f]


# the trainer's per-iteration host timings read from its spans
# (engine/trainer.py:span_scalars): wall-clock and process-wide, never compared
SPAN_SCALARS = ("queue_wait_time", "h2d_time", "dispatch_time", "backward_time", "fetch_time",
                "dispatch_cpu_time", "loader_cpu_time", "loader_images", "loader_queue_depth")


# torch's intra-op threads while a module's trainer runs: one per core is
# the default, and the suite's parallel workers, each with as many, then
# oversubscribe the CPU many times over (a 4 s run took 329 s so)
TEST_TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Autouse in the modules that import it: TEST_TORCH_THREADS intra-op
    threads, the count restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(TEST_TORCH_THREADS)
    yield
    torch.set_num_threads(before)


# what a port test may leave under its temp dir (its tmp_path, or a module
# fixture's mktemp dir) when it ends. pytest keeps the last three runs' temp
# dirs and deletes older ones only when a run exits, so a test that leaves
# checkpoints fills the disk across runs. About three times the most a port
# test leaves once its large files are gone: 5 MB (the soak's synthetic
# JPEGs, profile_step's trace; port_tools/test_footprint.py scan)
TMP_BUDGET = 16 << 20
# the files remove_large_files deletes: checkpoints, weights, rank and input
# files; logs, metrics.json, small JSON and the synthetic JPEGs stay
LARGE_FILE = 1 << 20


def tmp_footprint(root) -> tuple:
    """(bytes of the files under root, the five largest as (bytes, path
    relative to root))."""
    sizes = []
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            sizes.append((os.lstat(p).st_size, os.path.relpath(p, root)))
    return sum(s for s, _ in sizes), sorted(sizes, reverse=True)[:5]


def check_tmp_budget(root) -> None:
    """Fail if the files left under root hold more than TMP_BUDGET bytes,
    naming the five largest."""
    total, largest = tmp_footprint(root)
    if total > TMP_BUDGET:
        names = ", ".join(f"{p} ({s / 2**20:.1f} MiB)" for s, p in largest)
        pytest.fail(f"{root} holds {total / 2**20:.1f} MiB after the test, over the budget of "
                    f"{TMP_BUDGET / 2**20:.0f} MiB; the largest files: {names}", pytrace=False)


def remove_large_files(root) -> None:
    """Delete every file of at least LARGE_FILE bytes under root."""
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if os.lstat(p).st_size >= LARGE_FILE:
                os.unlink(p)


@pytest.fixture(autouse=True)
def tmp_budget(request):
    """Autouse in the modules that import it: check_tmp_budget on the test's
    tmp_path when the test ends (a test without one passes through)."""
    root = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if root is not None:
        check_tmp_budget(root)


def remove_large_files_at_teardown(request, root) -> None:
    """For a module fixture's mktemp dir: remove_large_files(root), then
    check_tmp_budget(root), when the fixture ends, whatever the outcome."""
    request.addfinalizer(lambda: check_tmp_budget(root))
    request.addfinalizer(lambda: remove_large_files(root))


@pytest.fixture
def large_files_removed(tmp_path):
    """remove_large_files(tmp_path) when the test ends, whatever its outcome
    (before tmp_budget looks)."""
    yield
    remove_large_files(tmp_path)
