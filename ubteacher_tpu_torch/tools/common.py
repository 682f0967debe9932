"""What the port's tools and `chip_smoke.py` share: the recipes' config
files, the device rule (the card unless the CPU is asked for; no card stops
the tool), the card's name, power limit and dense-bf16 peak, and the
full-width mutual-step setup (seeded weights and batch) that the step
profile, the stem A/B and the FLOP count drive.
"""

from __future__ import annotations

import os
import subprocess

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FCOS_CFG = os.path.join(REPO, "configs", "FCOS", "coco-standard", "fcos_R_50_ut2_sup1_run0.yaml")
RCNN_CFG = os.path.join(REPO, "configs", "Faster-RCNN", "coco-standard", "faster_rcnn_R_50_FPN_ut2_sup1_run0.yaml")
# the recipes' train canvas and per-card batch (8 labeled + 8 unlabeled)
CANVAS = (768, 1344)
BATCH = 8
# the slice's bias tricks, so that random weights feed the teacher's NMS and
# pseudo labels real work: FCOS sigmoid(1.0) = 0.73 passes INFERENCE_TH_TRAIN
# and BBOX_THRESHOLD 0.5 (the prior-probability bias -4.6 feeds NMS nothing);
# R-CNN class 0's softmax exp(6) / (exp(6) + 80) = 0.83 passes 0.7
FCOS_CLS_BIAS = 1.0
RCNN_CLS_BIAS = 6.0
# dense bf16 tensor-core peaks (NVIDIA's H100 data sheet, no sparsity)
PEAK_BF16 = {"H100 SXM": 989e12, "H100 PCIe": 756e12}


def triton_cache_in_checkout() -> None:
    """Triton's compile cache inside the checkout, beside the nvcc build
    (a tool's entry point calls this before the first launch)."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "ubteacher_tpu_torch", "_build", "triton"))


def tool_device(cpu: bool) -> torch.device:
    """--cpu -> the CPU; otherwise the first card, and without one the tool
    stops: it never carries on on the CPU unasked."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the card (pass --cpu to run on the CPU)")
    return torch.device("cuda", 0)


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_label(device: torch.device) -> str:
    return "cpu" if device.type == "cpu" else gpu_name_and_power()


def peak_bf16(device_name: str) -> tuple:
    """(part, dense bf16 FLOP/s) of an H100 by its name: the PCIe card's
    peak where the name says PCIe, else the SXM part's."""
    part = "H100 PCIe" if "pcie" in device_name.lower() else "H100 SXM"
    return part, PEAK_BF16[part]


def load_cfg(opts=(), path=FCOS_CFG):
    from ..config import add_ubteacher_config, get_cfg

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def synthetic_batch(cfg, b_label, b_unlabel, canvas, gen, device, num_classes=None):
    """Seeded images in [0, 255] and up to 12 gt boxes per labeled image."""
    from ..structures import PaddedInstances

    h, w = canvas
    m = cfg.TPU.MAX_GT
    nb = min(12, m)
    boxes = torch.zeros((b_label, m, 4), device=device)
    x0 = torch.rand((b_label, nb), generator=gen, device=device) * (w * 0.8)
    y0 = torch.rand((b_label, nb), generator=gen, device=device) * (h * 0.8)
    bw = torch.rand((b_label, nb), generator=gen, device=device) * (w * 0.15) + 8
    bh = torch.rand((b_label, nb), generator=gen, device=device) * (h * 0.15) + 8
    boxes[:, :nb] = torch.stack([x0, y0, x0 + bw, y0 + bh], -1)
    num_classes = cfg.MODEL.FCOS.NUM_CLASSES if num_classes is None else num_classes
    classes = torch.randint(0, num_classes, (b_label, m), generator=gen, device=device)
    mask = torch.zeros((b_label, m), dtype=torch.bool, device=device)
    mask[:, :nb] = True
    gt = PaddedInstances(boxes, classes, torch.ones((b_label, m), device=device),
                         torch.zeros((b_label, m, 4), device=device), mask)

    def images(b):
        return (torch.randn((b, h, w, 3), generator=gen, device=device) * 45 + 110).clamp(0, 255)

    return {"images_label_k": images(b_label), "gt_label": gt, "images_unlabel_k": images(b_unlabel)}


def build_fcos_model(cfg, device, seed, cls_bias):
    """OneStageDetector from `seed` (drawn on the CPU, so every device gets
    the same weights) with every cls_logits bias set to `cls_bias`."""
    from ..modeling.fcos_head import build_one_stage_detector

    model = build_one_stage_detector(cfg, device, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(cls_bias)
    return model


def build_state(cfg, device, seed, cls_bias):
    from ..engine import FCOSTrainState
    from ..solver import build_optimizer

    model = build_fcos_model(cfg, device, seed, cls_bias)
    return FCOSTrainState.create(model, build_optimizer(cfg, model))


def build_rcnn_model(cfg, device, seed, cls_bias):
    """TwoStageRCNN from `seed` (drawn on the CPU) with class 0's cls_score
    bias set to `cls_bias`."""
    from ..modeling.rcnn import build_two_stage_rcnn

    model = build_two_stage_rcnn(cfg, device, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.box_predictor.cls_score.bias[0] = cls_bias
    return model


def build_rcnn_state(cfg, device, seed, cls_bias):
    from ..engine.rcnn_trainer import RCNNTrainState
    from ..solver import build_optimizer

    model = build_rcnn_model(cfg, device, seed, cls_bias)
    return RCNNTrainState.create(model, build_optimizer(cfg, model))


def step_setup(rcnn: bool, device, batch: int = BATCH, canvas=CANVAS, opts=()):
    """A recipe's train steps at full width with BURN_UP_STEP 1, seeded
    weights (seed 0, the bias trick above) and a seeded batch of `batch`
    labeled + `batch` unlabeled images on `canvas`: -> (cfg, (burnin_step,
    mutual_step), state, batch). `opts` are KEY VALUE overrides."""
    opts = ["SEMISUPNET.BURN_UP_STEP", "1"] + list(opts)
    gen = torch.Generator(device=device).manual_seed(1)
    if rcnn:
        from ..engine.rcnn_trainer import make_rcnn_train_steps

        cfg = load_cfg(opts, RCNN_CFG)
        state = build_rcnn_state(cfg, device, seed=0, cls_bias=RCNN_CLS_BIAS)
        data = synthetic_batch(cfg, batch, batch, canvas, gen, device, num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES)
        steps = make_rcnn_train_steps(cfg)
    else:
        from ..engine import make_fcos_train_steps

        cfg = load_cfg(opts)
        state = build_state(cfg, device, seed=0, cls_bias=FCOS_CLS_BIAS)
        data = synthetic_batch(cfg, batch, batch, canvas, gen, device)
        steps = make_fcos_train_steps(cfg)
    data["rng"] = torch.Generator(device=device).manual_seed(2)
    return cfg, steps, state, data
