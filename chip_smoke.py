#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ubteacher_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Setup: prints the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and builds the hand-written kernels from this checkout's
   sources (the CUDA NMS library with nvcc; the Triton kernels compile at
   their first launch).
2. Kernel phase: each kernel against its plain PyTorch version at the main
   path's shapes (NMS: 8 images x 5000 class-offset candidates, t = 0.6;
   focal forward and backward: (343776, 80); GIoU: 343776 rows), with kernel
   and plain times as the median of 20 runs timed with CUDA events.
3. Reference phase: one mutual step at a small size (the CPU parity tests'
   configuration) on the card through the kernels and on the CPU through the
   plain versions, from the same weights, batch and augmentation draws; the
   metrics must agree.
4. Slice phase: the FCOS semi-supervised recipe
   configs/FCOS/coco-standard/fcos_R_50_ut2_sup1_run0.yaml at full R-50
   width with 80 classes, canvas 768x1344, 8 labeled + 8 unlabeled images,
   random weights from a seed: one burn-in step, the boundary copy, and three
   mutual steps, with every kernel's launch count taken over exactly that run.

Prints the kernels' JSON line second to last and
{"ok": true, "device": {...}} last; exits nonzero, with no result line, on
any failure or when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "configs", "FCOS", "coco-standard", "fcos_R_50_ut2_sup1_run0.yaml")
CANVAS = (768, 1344)
BATCH_LABEL = BATCH_UNLABEL = 8
MUTUAL_STEPS = 3
NMS_B, NMS_K, NMS_T = 8, 5000, 0.6
FOCAL_N, FOCAL_C = 16 * 21486, 80  # labeled strong + weak at 768x1344
GIOU_N = 16 * 21486
TIMED_RUNS = 20
# cls_logits bias for the slice: sigmoid(1.0) = 0.73 lifts the random-init
# teacher's scores past INFERENCE_TH_TRAIN (0.05) and BBOX_THRESHOLD (0.5);
# with the prior-probability bias (-4.6) a teacher on noise feeds NMS nothing
SLICE_CLS_BIAS = 1.0


def log(*args) -> None:
    print(*args, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------


def clustered_boxes(gen, device):
    """NMS_B images of NMS_K boxes around 60 cluster centres, 80 classes."""
    import torch

    centres = torch.rand((NMS_B, 60, 2), generator=gen, device=device) * torch.tensor(
        [CANVAS[1], CANVAS[0]], device=device)
    pick = torch.randint(0, 60, (NMS_B, NMS_K), generator=gen, device=device)
    ctr = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2))
    ctr = ctr + torch.randn((NMS_B, NMS_K, 2), generator=gen, device=device) * 12.0
    wh = torch.rand((NMS_B, NMS_K, 2), generator=gen, device=device) * 150.0 + 16.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    classes = torch.randint(0, 80, (NMS_B, NMS_K), generator=gen, device=device)
    scores = torch.rand((NMS_B, NMS_K), generator=gen, device=device)
    valid = torch.rand((NMS_B, NMS_K), generator=gen, device=device) < 0.97
    valid[1, 2000:] = False  # per-image counts differ
    valid[2] = False
    return boxes, scores, classes, valid


def nms_inputs(boxes, scores, classes, valid):
    """Class-offset, score-sorted candidates as ops.nms hands them to the
    kernel."""
    import torch

    max_coord = torch.where(valid[..., None], boxes, 0.0).amax(dim=(-2, -1)) + 1.0
    shifted = boxes + (classes.float() * max_coord[:, None])[..., None]
    masked = torch.where(valid, scores, float("-inf"))
    order = torch.argsort(-masked, dim=-1, stable=True)
    sboxes = torch.gather(shifted, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    return sboxes, valid.sum(-1, dtype=torch.int32)


def settle_nms(sboxes, nvalid, got, ref) -> int:
    """Mismatched keep flags not explained by a pair whose float64 IoU lies
    within 1e-6 of the threshold (those may round either way in float32)."""
    import numpy as np

    unsettled = 0
    diff = (got != ref).cpu().numpy()
    for b in np.nonzero(diff.any(1))[0]:
        n = int(nvalid[b])
        bx = sboxes[b, :n].double().cpu().numpy()
        area = np.clip(bx[:, 2] - bx[:, 0], 0, None) * np.clip(bx[:, 3] - bx[:, 1], 0, None)
        iw = np.clip(np.minimum(bx[:, None, 2], bx[None, :, 2]) - np.maximum(bx[:, None, 0], bx[None, :, 0]), 0, None)
        ih = np.clip(np.minimum(bx[:, None, 3], bx[None, :, 3]) - np.maximum(bx[:, None, 1], bx[None, :, 1]), 0, None)
        inter = iw * ih
        iou = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-12)
        near = np.abs(iou - NMS_T) <= 1e-6
        for j in np.nonzero(diff[b])[0]:
            if not near[:j, j].any():
                unsettled += 1
    return unsettled


def kernel_phase(device):
    import torch

    from ubteacher_tpu_torch.ops import losses
    from ubteacher_tpu_torch.ops.kernels import focal_triton, giou_triton, nms_cuda

    gen = torch.Generator(device=device).manual_seed(0)
    results = []

    # --- NMS ---
    sboxes, nvalid = nms_inputs(*clustered_boxes(gen, device))
    got = nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, NMS_T)
    ref = nms_cuda.nms_sorted_keep_plain(sboxes, nvalid, NMS_T)
    torch.cuda.synchronize()
    unsettled = settle_nms(sboxes, nvalid, got, ref)
    log(f"nms: valid {nvalid.tolist()} kept {got.sum(-1).tolist()} "
        f"mismatches {int((got != ref).sum())} unsettled {unsettled}")
    if unsettled:
        raise AssertionError(f"NMS kernel disagrees with its plain version on {unsettled} candidates")
    results.append({
        "name": "nms", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/nms.cu",
        "replaces": "ubteacher_tpu/ops/pallas/nms_pallas.py:203",
        "max_abs_err": float(unsettled),
        "ms": median_ms(lambda: nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, NMS_T)),
        "plain_ms": median_ms(lambda: nms_cuda.nms_sorted_keep_plain(sboxes, nvalid, NMS_T)),
    })

    # --- focal forward and backward ---
    x = torch.randn((FOCAL_N, FOCAL_C), generator=gen, device=device) * 2.0 - 3.0
    labels = torch.randint(0, FOCAL_C + 40, (FOCAL_N,), generator=gen, device=device)
    t = (labels[:, None] == torch.arange(FOCAL_C, device=device)).float()
    g = torch.rand((FOCAL_N, FOCAL_C), generator=gen, device=device)
    fwd = focal_triton.focal_forward_kernel(x, t, 0.25, 2.0)
    fwd_ref = losses.sigmoid_focal_loss(x, t, 0.25, 2.0)
    bwd = focal_triton.focal_backward_kernel(x, t, g, 0.25, 2.0)
    bwd_ref = losses.sigmoid_focal_loss_grad(x, t, g, 0.25, 2.0)
    torch.cuda.synchronize()
    # float32 elementwise math with Triton's exp/sigmoid vs torch's: a few ulps
    for name, a, b in (("focal_fwd", fwd, fwd_ref), ("focal_bwd", bwd, bwd_ref)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{name}: max abs err {float((a - b).abs().max())}")
    results.append({
        "name": "focal_fwd", "route": "triton",
        "source": "ubteacher_tpu_torch/ops/kernels/_focal_jit.py",
        "replaces": "ubteacher_tpu/ops/pallas/focal_pallas.py:74",
        "max_abs_err": float((fwd - fwd_ref).abs().max()),
        "ms": median_ms(lambda: focal_triton.focal_forward_kernel(x, t, 0.25, 2.0)),
        "plain_ms": median_ms(lambda: losses.sigmoid_focal_loss(x, t, 0.25, 2.0)),
    })
    results.append({
        "name": "focal_bwd", "route": "triton",
        "source": "ubteacher_tpu_torch/ops/kernels/_focal_jit.py",
        "replaces": "ubteacher_tpu/ops/pallas/focal_pallas.py:33",
        "max_abs_err": float((bwd - bwd_ref).abs().max()),
        "ms": median_ms(lambda: focal_triton.focal_backward_kernel(x, t, g, 0.25, 2.0)),
        "plain_ms": median_ms(lambda: losses.sigmoid_focal_loss_grad(x, t, g, 0.25, 2.0)),
    })

    # --- GIoU ---
    p = torch.rand((GIOU_N, 4), generator=gen, device=device) * 12.0 + 0.05
    q = torch.rand((GIOU_N, 4), generator=gen, device=device) * 12.0 + 0.05
    w = torch.rand((GIOU_N,), generator=gen, device=device)
    rows = giou_triton.giou_rows_kernel(p, q, w)
    rows_ref = giou_triton.giou_rows_plain(p, q, w)
    torch.cuda.synchronize()
    if not torch.allclose(rows, rows_ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"giou_fwd: max abs err {float((rows - rows_ref).abs().max())}")
    results.append({
        "name": "giou_fwd", "route": "triton",
        "source": "ubteacher_tpu_torch/ops/kernels/_giou_jit.py",
        "replaces": "ubteacher_tpu/ops/pallas/giou_pallas.py:52",
        "max_abs_err": float((rows - rows_ref).abs().max()),
        "ms": median_ms(lambda: giou_triton.giou_rows_kernel(p, q, w)),
        "plain_ms": median_ms(lambda: giou_triton.giou_rows_plain(p, q, w)),
    })
    for r in results:
        log(f"kernel {r['name']}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, "
            f"max abs err {r['max_abs_err']:.3g}")
    return results


# --------------------------------------------------------------------------
# setup shared by the reference and slice phases
# --------------------------------------------------------------------------


def load_cfg(opts):
    from ubteacher_tpu_torch.config import add_ubteacher_config, get_cfg

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    cfg.merge_from_file(CFG)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def synthetic_batch(cfg, b_label, b_unlabel, canvas, gen, device):
    """Seeded images in [0, 255] and up to 12 gt boxes per labeled image."""
    import torch

    from ubteacher_tpu_torch.structures import PaddedInstances

    h, w = canvas
    m = cfg.TPU.MAX_GT
    nb = min(12, m)
    boxes = torch.zeros((b_label, m, 4), device=device)
    x0 = torch.rand((b_label, nb), generator=gen, device=device) * (w * 0.8)
    y0 = torch.rand((b_label, nb), generator=gen, device=device) * (h * 0.8)
    bw = torch.rand((b_label, nb), generator=gen, device=device) * (w * 0.15) + 8
    bh = torch.rand((b_label, nb), generator=gen, device=device) * (h * 0.15) + 8
    boxes[:, :nb] = torch.stack([x0, y0, x0 + bw, y0 + bh], -1)
    classes = torch.randint(0, cfg.MODEL.FCOS.NUM_CLASSES, (b_label, m), generator=gen, device=device)
    mask = torch.zeros((b_label, m), dtype=torch.bool, device=device)
    mask[:, :nb] = True
    gt = PaddedInstances(boxes, classes, torch.ones((b_label, m), device=device),
                         torch.zeros((b_label, m, 4), device=device), mask)

    def images(b):
        return (torch.randn((b, h, w, 3), generator=gen, device=device) * 45 + 110).clamp(0, 255)

    return {"images_label_k": images(b_label), "gt_label": gt, "images_unlabel_k": images(b_unlabel)}


def to_device(value, device):
    """A tensor or a dataclass of tensors (PaddedInstances, StrongAugParams)
    on `device`."""
    if dataclasses.is_dataclass(value):
        return type(value)(**{f.name: getattr(value, f.name).to(device)
                              for f in dataclasses.fields(value)})
    return value.to(device)


def build_state(cfg, device, seed, cls_bias):
    import torch

    from ubteacher_tpu_torch.engine import FCOSTrainState
    from ubteacher_tpu_torch.modeling.fcos_head import build_one_stage_detector
    from ubteacher_tpu_torch.solver import build_optimizer

    model = build_one_stage_detector(cfg, device, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(cls_bias)
    return FCOSTrainState.create(model, build_optimizer(cfg, model))


# --------------------------------------------------------------------------
# reference phase: kernels on the card vs plain versions on the CPU
# --------------------------------------------------------------------------


def reference_phase(device) -> None:
    import torch

    from ubteacher_tpu_torch.data.augment import draw_strong_params
    from ubteacher_tpu_torch.engine import make_fcos_train_steps

    # the CPU parity tests' configuration; the card runs it in float32
    cfg = load_cfg([
        "MODEL.RESNETS.DEPTH", "18", "MODEL.FCOS.NUM_CLASSES", "4",
        "TPU.COMPUTE_DTYPE", "float32", "TPU.MAX_GT", "4", "TPU.MAX_PSEUDO", "10",
        "TPU.NMS_CANDIDATES", "50", "SEMISUPNET.BURN_UP_STEP", "0",
    ])
    canvas = (64, 96)
    cpu = torch.device("cpu")
    batch = synthetic_batch(cfg, 2, 2, canvas, torch.Generator().manual_seed(100), cpu)
    draws = torch.Generator().manual_seed(7)
    batch["strong_label"] = draw_strong_params(2, *canvas, draws)
    batch["strong_unlabel"] = draw_strong_params(2, *canvas, draws)
    _, mutual = make_fcos_train_steps(cfg)
    metrics = {}
    for dev in (cpu, device):
        state = build_state(cfg, dev, seed=0, cls_bias=0.5)
        _, m = mutual(state, {k: to_device(v, dev) for k, v in batch.items()})
        metrics[dev.type] = {k: float(v) for k, v in m.items()}
    ref, got = metrics["cpu"], metrics["cuda"]
    log("reference phase (cpu plain vs cuda kernels):",
        {k: (round(ref[k], 6), round(got[k], 6)) for k in ref})
    for k in ("num_pseudo_cls", "num_pseudo_reg", "num_nms_candidates"):
        if got[k] != ref[k]:
            raise AssertionError(f"reference phase: {k} {got[k]} != {ref[k]}")
    if ref["num_pseudo_cls"] <= 0:
        raise AssertionError("reference phase: the teacher produced no pseudo boxes")
    # cuDNN and the CPU sum convolutions in other orders (TF32 is off)
    for k, v in ref.items():
        if abs(got[k] - v) > 1e-3 * abs(v) + 1e-4:
            raise AssertionError(f"reference phase: {k} cuda {got[k]} vs cpu {v}")


# --------------------------------------------------------------------------
# slice phase
# --------------------------------------------------------------------------


def slice_phase(device):
    import math

    import torch

    from ubteacher_tpu_torch.engine import make_fcos_train_steps
    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = load_cfg(["SEMISUPNET.BURN_UP_STEP", "1"])
    state = build_state(cfg, device, seed=0, cls_bias=SLICE_CLS_BIAS)
    n_params = sum(p.numel() for p in state.student.parameters())
    burnin, mutual = make_fcos_train_steps(cfg)
    batch = synthetic_batch(cfg, BATCH_LABEL, BATCH_UNLABEL, CANVAS,
                            torch.Generator(device=device).manual_seed(1), device)
    batch["rng"] = torch.Generator(device=device).manual_seed(2)
    log(f"slice: R-{cfg.MODEL.RESNETS.DEPTH} FCOS, {cfg.MODEL.FCOS.NUM_CLASSES} classes, "
        f"{n_params} parameters, canvas {CANVAS}, {BATCH_LABEL}+{BATCH_UNLABEL} images, "
        f"compute {cfg.TPU.COMPUTE_DTYPE}")

    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    history = []
    for i in range(1 + MUTUAL_STEPS):
        t0 = time.perf_counter()
        step = burnin if state.step < cfg.SEMISUPNET.BURN_UP_STEP else mutual
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in metrics.items()}
        history.append((step is mutual, m))
        log(f"step {i} ({'mutual' if step is mutual else 'burn-in'}) {ms:.1f} ms: "
            + ", ".join(f"{k}={v:.6g}" for k, v in m.items()))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"launches {counts}; max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")

    for _, m in history:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics {bad}")
    mutual_metrics = [m for is_mutual, m in history if is_mutual]
    if mutual_metrics[0]["ema_rate_1000x"] != 0.0:
        raise AssertionError("the boundary step must copy the student (ema_rate_1000x 0)")
    for m in mutual_metrics[1:]:
        if abs(m["ema_rate_1000x"] - 1000 * cfg.SEMISUPNET.EMA_KEEP_RATE) > 1e-3:
            raise AssertionError(f"ema_rate_1000x {m['ema_rate_1000x']}")
    if not any(m["num_nms_candidates"] > 0 and m["num_pseudo_cls"] > 0
               and m["num_pseudo_reg"] > 0 for m in mutual_metrics):
        raise AssertionError("no mutual step had NMS candidates and pseudo boxes")
    if counts["nms"] != 2 * MUTUAL_STEPS:
        raise AssertionError(f"NMS launched {counts['nms']} times, expected {2 * MUTUAL_STEPS}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return counts


def main() -> int:
    # Triton's compile cache stays inside the checkout, beside the nvcc build
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "ubteacher_tpu_torch", "_build", "triton"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name_power = gpu_name_and_power()
    log(name_power)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from ubteacher_tpu_torch.ops.kernels import nms_cuda

    t0 = time.perf_counter()
    _, ptxas_report = nms_cuda.build()
    log(f"built csrc/nms.cu in {time.perf_counter() - t0:.2f} s (Triton kernels compile at first launch)")
    if ptxas_report:
        log(ptxas_report.strip())

    t0 = time.perf_counter()
    kernels = kernel_phase(device)
    log(f"kernel phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reference_phase(device)
    log(f"reference phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = slice_phase(device)
    log(f"slice phase {time.perf_counter() - t0:.1f} s")

    for k in kernels:
        k["launches"] = counts[k["name"]]
    log(name_power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
