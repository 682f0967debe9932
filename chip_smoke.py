#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ubteacher_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Setup: prints the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and builds the hand-written kernels from this checkout's
   sources (one nvcc per CUDA source, all started together; the Triton
   kernels compile at their first launch).
2. Kernel phase: each kernel against its plain PyTorch version at the main
   paths' shapes, with kernel and plain times as the median of 20 runs timed
   with CUDA events. FCOS: NMS 8 images x 5000 class-offset candidates,
   t = 0.6; focal forward and backward (343776, 80); GIoU 343776 rows.
   Faster R-CNN: the anchor matcher over 257,796 anchors x (24, 100) gt
   slots (bitwise); ROIAlign forward and backward over p2-p5 of 24 images,
   256 channels, 512 rois per image (float32 and bfloat16); the row scatter
   (24, 320, 3) and (24, 320, 12) into 85,932 rows.
3. FCOS reference phase: one mutual step at a small size (the CPU parity
   tests' configuration) on the card through the kernels and on the CPU
   through the plain versions, from the same weights, batch and augmentation
   draws; the metrics must agree.
4. FCOS slice phase: configs/FCOS/coco-standard/fcos_R_50_ut2_sup1_run0.yaml
   at full R-50 width with 80 classes, canvas 768x1344, 8 labeled + 8
   unlabeled images, random weights from a seed: one burn-in step, the
   boundary copy, and three mutual steps, with the FCOS kernels' launch
   counts taken over exactly that run.
5. Faster R-CNN reference phase: the CPU parity tests' small configuration
   (R-18, 3 classes, 64x64), one mutual step (oracle pseudo labels) and the
   teacher branch (make_rcnn_inference_fn and the BBOX_THRESHOLD cut), on
   the card through the kernels and on the CPU through the plain versions,
   from the same weights, batch and injected sampling draws; counts must be
   equal and losses and detections agree.
6. Faster R-CNN slice phase:
   configs/Faster-RCNN/coco-standard/faster_rcnn_R_50_FPN_ut2_sup1_run0.yaml
   at full width (R-50-FPN P2-P6, 80 classes, 3 anchors per cell), canvas
   768x1344, 8+8 images, random weights from a seed: one burn-in step, the
   boundary copy and three mutual steps, with exact launch counts of the
   R-CNN kernels over that run.

Prints the kernels' JSON line second to last and
{"ok": true, "device": {...}} last; exits nonzero, with no result line, on
any failure or when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "configs", "FCOS", "coco-standard", "fcos_R_50_ut2_sup1_run0.yaml")
RCNN_CFG = os.path.join(ROOT, "configs", "Faster-RCNN", "coco-standard",
                        "faster_rcnn_R_50_FPN_ut2_sup1_run0.yaml")
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
FCOS_KERNELS = ("nms", "focal_fwd", "focal_bwd", "giou_fwd")

# Faster R-CNN main path: the fused mutual step's student batch is labeled
# strong + weak + unlabeled strong (3 x 8), every RPN image samples 64
# positive slots + 256 rois, and p2-p5 pool 512 rois per image
RCNN_STUDENT = 3 * BATCH_LABEL
RCNN_STRIDES = (4, 8, 16, 32, 64)
RCNN_GT_SLOTS = 100
RCNN_RPN_ROWS = 64 + 256
RCNN_ROIS = 512
# class 0's cls_score bias for the slice: softmax exp(6) / (exp(6) + 80)
# = 0.83 passes BBOX_THRESHOLD 0.7, so the random-init teacher yields pseudo
# boxes and the teacher's ROIAlign and both NMS calls see real work
RCNN_SLICE_CLS_BIAS = 6.0
# the CPU parity tests' small R-CNN configuration (tests/torch_parity.py)
RCNN_SMALL_OPTS = [
    "MODEL.ROI_HEADS.NUM_CLASSES", "3", "MODEL.RESNETS.DEPTH", "18",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "64",
    "TEST.DETECTIONS_PER_IMAGE", "20", "TPU.COMPUTE_DTYPE", "float32", "TPU.MAX_GT", "8",
    "TPU.MAX_PSEUDO", "20", "TPU.NMS_CANDIDATES", "100", "SEMISUPNET.BURN_UP_STEP", "1",
    "TPU.ORACLE_PSEUDO", "True",
]
RCNN_SMALL_CANVAS = (64, 64)


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


def build_kernels() -> None:
    from ubteacher_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"built {len(built)} CUDA libraries in {time.perf_counter() - t0:.2f} s "
        "(Triton kernels compile at first launch)")
    for name, (_, report, seconds) in built.items():
        log(f"  csrc/{name}.cu: {seconds:.2f} s")
        for line in report.strip().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


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


def fcos_kernel_rows(device, gen):
    import torch

    from ubteacher_tpu_torch.ops import losses
    from ubteacher_tpu_torch.ops.kernels import focal_triton, giou_triton, nms_cuda

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
    return results


def rcnn_anchors(canvas, device):
    from ubteacher_tpu_torch.modeling.anchors import generate_anchors

    return generate_anchors(canvas, RCNN_STRIDES, [[32], [64], [128], [256], [512]],
                            [[0.5, 1.0, 2.0]], 0.0, device)


def matcher_gt(gen, device, anchors):
    """(24, 100) gt slots as the fused step feeds the matcher: a prefix of
    valid boxes per image (0 to 40), clipped to the canvas, with an empty
    image, a valid last slot, duplicated gts (IoU ties across gts), a gt
    equal to an anchor (IoU exactly 1) and a zero-area gt."""
    import torch

    b, m = RCNN_STUDENT, RCNN_GT_SLOTS
    h, w = CANVAS
    x0 = torch.rand((b, m), generator=gen, device=device) * w * 0.95 - 20
    y0 = torch.rand((b, m), generator=gen, device=device) * h * 0.95 - 20
    bw = torch.rand((b, m), generator=gen, device=device) * 500 + 2
    bh = torch.rand((b, m), generator=gen, device=device) * 350 + 2
    boxes = torch.stack([x0, y0, x0 + bw, y0 + bh], -1)
    boxes = torch.minimum(torch.maximum(boxes, torch.zeros((), device=device)),
                          torch.tensor([w, h, w, h], dtype=torch.float32, device=device))
    n = torch.randint(0, 41, (b, 1), generator=gen, device=device)
    mask = torch.arange(m, device=device)[None] < n
    mask[0] = False
    mask[1, -1] = True
    boxes[2, 1] = boxes[2, 0]
    mask[2, :2] = True
    boxes[3, 0] = anchors[123456]
    mask[3, 0] = True
    boxes[4, 0] = torch.tensor([100.0, 100.0, 100.0, 180.0], device=device)
    mask[4, 0] = True
    return boxes.contiguous(), mask.contiguous()


def rcnn_rois(gen, device, b, r):
    """(b * r, 4) proposal-like rois on the canvas: sqrt(area) log-uniform in
    [12, 900] px, aspect ratio in [1/3, 3], clipped (so some are thin or
    lie on the border)."""
    import torch

    h, w = CANVAS
    cx = torch.rand((b * r,), generator=gen, device=device) * w
    cy = torch.rand((b * r,), generator=gen, device=device) * h
    size = torch.exp(torch.rand((b * r,), generator=gen, device=device) * math.log(900 / 12)) * 12
    ratio = torch.exp((torch.rand((b * r,), generator=gen, device=device) * 2 - 1) * math.log(3))
    bw, bh = size * ratio.sqrt(), size / ratio.sqrt()
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=device)
    return torch.minimum(torch.maximum(boxes, torch.zeros((), device=device)), lim).contiguous()


def rcnn_kernel_rows(device, gen):
    import torch

    from ubteacher_tpu_torch.ops.kernels import matcher_cuda, roi_align_cuda, row_scatter_cuda
    from ubteacher_tpu_torch.ops.roi_align import assign_levels

    results = []

    # --- anchor matcher: bitwise ---
    anchors = rcnn_anchors(CANVAS, device)["anchors"]
    gt, mask = matcher_gt(gen, device, anchors)
    idx, lab = matcher_cuda.match_anchors_kernel(anchors, gt, mask)
    idx_ref, lab_ref = matcher_cuda.match_anchors_plain(anchors, gt, mask)
    torch.cuda.synchronize()
    wrong = int((idx != idx_ref).sum() + (lab != lab_ref).sum())
    log(f"matcher: {anchors.shape[0]} anchors x {tuple(mask.shape)} gt slots, valid per image "
        f"{mask.sum(-1).tolist()}, positives {int((lab == 1).sum())}, ignored {int((lab == -1).sum())}, "
        f"mismatched entries {wrong}")
    if wrong:
        raise AssertionError(f"matcher kernel differs from its plain version in {wrong} entries")
    results.append({
        "name": "matcher", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/matcher.cu",
        "replaces": "ubteacher_tpu/ops/pallas/matcher_pallas.py:182",
        "max_abs_err": float(max((idx - idx_ref).abs().max(), (lab - lab_ref).abs().max())),
        "ms": median_ms(lambda: matcher_cuda.match_anchors_kernel(anchors, gt, mask)),
        "plain_ms": median_ms(lambda: matcher_cuda.match_anchors_plain(anchors, gt, mask)),
    })
    del idx_ref, lab_ref
    torch.cuda.empty_cache()

    # --- ROIAlign forward and backward, float32 and bfloat16 ---
    b, c, p, r = RCNN_STUDENT, 256, 7, RCNN_ROIS
    h, w = CANVAS
    feats = [torch.randn((b, c, h >> lv, w >> lv), generator=gen, device=device) for lv in (2, 3, 4, 5)]
    scales = [1.0 / 2**lv for lv in (2, 3, 4, 5)]
    boxes = rcnn_rois(gen, device, b, r)
    level = (assign_levels(boxes, 2, 5) - 2).contiguous()
    args = (boxes, level, r, scales, p, 0)
    log(f"roi_align: {tuple(boxes.shape)} rois, per level {torch.bincount(level.long(), minlength=4).tolist()}, "
        f"p2 {tuple(feats[0].shape)}")
    feats16 = [f.bfloat16() for f in feats]
    # accumulated in float32 in both; the sums run in other orders (rtol 1e-5),
    # and in bfloat16 each result is rounded once, so the two may sit one
    # bf16 ulp (2^-7 relative) apart
    out32 = roi_align_cuda.roi_align_forward_kernel(feats, *args)
    ref32 = roi_align_cuda.roi_align_plain(feats, *args)
    out16 = roi_align_cuda.roi_align_forward_kernel(feats16, *args)
    ref16 = roi_align_cuda.roi_align_plain(feats16, *args)
    torch.cuda.synchronize()
    err32 = float((out32 - ref32).abs().max())
    err16 = float((out16.float() - ref16.float()).abs().max())
    log(f"roi_align_fwd: max abs err float32 {err32:.3g}, bfloat16 {err16:.3g} (|out| max "
        f"{float(ref32.abs().max()):.3g})")
    if not torch.allclose(out32, ref32, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"roi_align_fwd float32: max abs err {err32}")
    if not torch.allclose(out16.float(), ref16.float(), rtol=2**-7, atol=1e-5):
        raise AssertionError(f"roi_align_fwd bfloat16: max abs err {err16}")
    del out32, ref32, out16, ref16
    results.append({
        "name": "roi_align_fwd", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/roi_align.cu",
        "replaces": "ubteacher_tpu/ops/pallas/roi_align_pallas.py:894",
        "max_abs_err": err16,
        "ms": median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(feats16, *args)),
        "plain_ms": median_ms(lambda: roi_align_cuda.roi_align_plain(feats16, *args)),
        "ms_f32": median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(feats, *args)),
    })

    grad = torch.randn((b * r, p, p, c), generator=gen, device=device)
    grad16 = grad.bfloat16()
    leaves = [f.clone().requires_grad_(True) for f in feats]
    plain_out = roi_align_cuda.roi_align_plain(leaves, *args)
    ref_g = torch.autograd.grad(plain_out, leaves, grad, retain_graph=True)
    got_g = roi_align_cuda.roi_align_backward_kernel(grad, feats, *args)
    # bf16: the kernel on bf16 features and gradient against the plain
    # backward in float32 on the same (upcast) values, rounded once
    leaves16 = [f.float().requires_grad_(True) for f in feats16]
    ref_g16 = torch.autograd.grad(roi_align_cuda.roi_align_plain(leaves16, *args), leaves16, grad16.float())
    got_g16 = roi_align_cuda.roi_align_backward_kernel(grad16, feats16, *args)
    torch.cuda.synchronize()
    err32 = err16 = 0.0
    for lv, (a32, r32, a16, r16) in enumerate(zip(got_g, ref_g, got_g16, ref_g16)):
        # float32 atomics add in no fixed order: 1e-5 of the level's largest
        # gradient; bf16 adds one rounding of the result (2^-7 relative)
        scale = float(r32.abs().max())
        err32 = max(err32, float((a32 - r32).abs().max()))
        err16 = max(err16, float((a16.float() - r16).abs().max()))
        if not torch.allclose(a32, r32, rtol=1e-5, atol=1e-5 * scale):
            raise AssertionError(f"roi_align_bwd float32 p{lv + 2}: max abs err {float((a32 - r32).abs().max())}")
        if not torch.allclose(a16.float(), r16, rtol=2**-7, atol=1e-5 * scale):
            raise AssertionError(f"roi_align_bwd bfloat16 p{lv + 2}: max abs err "
                                 f"{float((a16.float() - r16).abs().max())}")
    log(f"roi_align_bwd: max abs err float32 {err32:.3g}, bfloat16 {err16:.3g} "
        f"(|grad| max {max(float(g.abs().max()) for g in ref_g):.3g})")
    del got_g, got_g16, ref_g16, leaves16
    results.append({
        "name": "roi_align_bwd", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/roi_align.cu",
        "replaces": "ubteacher_tpu/ops/pallas/roi_align_pallas.py:531",
        "max_abs_err": err16,
        "ms": median_ms(lambda: roi_align_cuda.roi_align_backward_kernel(grad16, feats16, *args)),
        "plain_ms": median_ms(lambda: torch.autograd.grad(plain_out, leaves, grad, retain_graph=True)),
        "ms_f32": median_ms(lambda: roi_align_cuda.roi_align_backward_kernel(grad, feats, *args)),
    })
    del feats, feats16, grad, grad16, leaves, plain_out, ref_g
    torch.cuda.empty_cache()

    # --- row scatter: the RPN gather's backward, duplicates accumulating ---
    length = sum(rcnn_anchors(CANVAS, "cpu")["level_lengths"]) // 3
    rows = torch.randint(0, length, (RCNN_STUDENT, RCNN_RPN_ROWS), generator=gen, device=device)
    rows[:, :40] = rows[:, :1]
    err = 0.0
    for d in (12, 3):
        g = torch.randn((RCNN_STUDENT, RCNN_RPN_ROWS, d), generator=gen, device=device)
        got = row_scatter_cuda.scatter_rows_kernel(g, rows, length)
        ref = row_scatter_cuda.scatter_rows_plain(g, rows, length)
        torch.cuda.synchronize()
        # float32 sums of the same terms, added in another order by the atomics
        if not torch.allclose(got, ref, rtol=1e-6, atol=1e-5):
            raise AssertionError(f"row_scatter D={d}: max abs err {float((got - ref).abs().max())}")
        err = max(err, float((got - ref).abs().max()))
    log(f"row_scatter: ({RCNN_STUDENT}, {RCNN_RPN_ROWS}, D) into {length} rows, max abs err {err:.3g}")
    g = torch.randn((RCNN_STUDENT, RCNN_RPN_ROWS, 12), generator=gen, device=device)
    results.append({
        "name": "row_scatter", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/row_scatter.cu",
        "replaces": "ubteacher_tpu/ops/pallas/row_gather_pallas.py:71",
        "max_abs_err": err,
        "ms": median_ms(lambda: row_scatter_cuda.scatter_rows_kernel(g, rows, length)),
        "plain_ms": median_ms(lambda: row_scatter_cuda.scatter_rows_plain(g, rows, length)),
    })
    return results


def kernel_phase(device):
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    results = fcos_kernel_rows(device, gen) + rcnn_kernel_rows(device, gen)
    for r in results:
        extra = f" (float32 {r['ms_f32']:.4f} ms)" if "ms_f32" in r else ""
        log(f"kernel {r['name']}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms{extra}, "
            f"max abs err {r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------
# setup shared by the reference and slice phases
# --------------------------------------------------------------------------


def load_cfg(opts, path=CFG):
    from ubteacher_tpu_torch.config import add_ubteacher_config, get_cfg

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    cfg.merge_from_file(path)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def synthetic_batch(cfg, b_label, b_unlabel, canvas, gen, device, num_classes=None):
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
    num_classes = cfg.MODEL.FCOS.NUM_CLASSES if num_classes is None else num_classes
    classes = torch.randint(0, num_classes, (b_label, m), generator=gen, device=device)
    mask = torch.zeros((b_label, m), dtype=torch.bool, device=device)
    mask[:, :nb] = True
    gt = PaddedInstances(boxes, classes, torch.ones((b_label, m), device=device),
                         torch.zeros((b_label, m, 4), device=device), mask)

    def images(b):
        return (torch.randn((b, h, w, 3), generator=gen, device=device) * 45 + 110).clamp(0, 255)

    return {"images_label_k": images(b_label), "gt_label": gt, "images_unlabel_k": images(b_unlabel)}


def to_device(value, device):
    """A tensor or a dataclass of tensors (PaddedInstances, StrongAugParams,
    SamplingDraws) on `device`."""
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


def build_rcnn_state(cfg, device, seed, cls_bias):
    """TwoStageRCNN from `seed` (drawn on the CPU, so every device gets the
    same weights) with class 0's cls_score bias set to `cls_bias`."""
    import torch

    from ubteacher_tpu_torch.engine.rcnn_trainer import RCNNTrainState
    from ubteacher_tpu_torch.modeling.rcnn import build_two_stage_rcnn
    from ubteacher_tpu_torch.solver import build_optimizer

    model = build_two_stage_rcnn(cfg, device, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.box_predictor.cls_score.bias[0] = cls_bias
    return RCNNTrainState.create(model, build_optimizer(cfg, model))


def run_slice(name, state, steps, batch, burn_up, device):
    """1 + MUTUAL_STEPS steps with the launch counts reset just before and
    read just after. Returns (per-step (is_mutual, metrics), counts)."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    burnin, mutual = steps
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    history = []
    for i in range(1 + MUTUAL_STEPS):
        t0 = time.perf_counter()
        step = burnin if state.step < burn_up else mutual
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in metrics.items()}
        history.append((step is mutual, m))
        log(f"{name} step {i} ({'mutual' if step is mutual else 'burn-in'}) {ms:.1f} ms: "
            + ", ".join(f"{k}={v:.6g}" for k, v in m.items()))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"{name} launches {counts}; max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    for _, m in history:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{name}: non-finite metrics {bad}")
    return history, counts


def check_ema(name, cfg, mutual_metrics) -> None:
    if mutual_metrics[0]["ema_rate_1000x"] != 0.0:
        raise AssertionError(f"{name}: the boundary step must copy the student (ema_rate_1000x 0)")
    for m in mutual_metrics[1:]:
        if abs(m["ema_rate_1000x"] - 1000 * cfg.SEMISUPNET.EMA_KEEP_RATE) > 1e-3:
            raise AssertionError(f"{name}: ema_rate_1000x {m['ema_rate_1000x']}")


def agree(name, got, ref, counts) -> None:
    """Counts equal; every other metric within 1e-3 relative + 1e-4: cuDNN and
    the CPU sum convolutions in other orders (TF32 is off)."""
    for k in counts:
        if got[k] != ref[k]:
            raise AssertionError(f"{name}: {k} {got[k]} != {ref[k]}")
    for k, v in ref.items():
        if abs(got[k] - v) > 1e-3 * abs(v) + 1e-4:
            raise AssertionError(f"{name}: {k} cuda {got[k]} vs cpu {v}")


# --------------------------------------------------------------------------
# FCOS reference phase: kernels on the card vs plain versions on the CPU
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
    agree("reference phase", got, ref, ("num_pseudo_cls", "num_pseudo_reg", "num_nms_candidates"))
    if ref["num_pseudo_cls"] <= 0:
        raise AssertionError("reference phase: the teacher produced no pseudo boxes")


# --------------------------------------------------------------------------
# FCOS slice phase
# --------------------------------------------------------------------------


def slice_phase(device):
    import torch

    from ubteacher_tpu_torch.engine import make_fcos_train_steps

    cfg = load_cfg(["SEMISUPNET.BURN_UP_STEP", "1"])
    state = build_state(cfg, device, seed=0, cls_bias=SLICE_CLS_BIAS)
    n_params = sum(p.numel() for p in state.student.parameters())
    batch = synthetic_batch(cfg, BATCH_LABEL, BATCH_UNLABEL, CANVAS,
                            torch.Generator(device=device).manual_seed(1), device)
    batch["rng"] = torch.Generator(device=device).manual_seed(2)
    log(f"slice: R-{cfg.MODEL.RESNETS.DEPTH} FCOS, {cfg.MODEL.FCOS.NUM_CLASSES} classes, "
        f"{n_params} parameters, canvas {CANVAS}, {BATCH_LABEL}+{BATCH_UNLABEL} images, "
        f"compute {cfg.TPU.COMPUTE_DTYPE}")

    history, counts = run_slice("fcos", state, make_fcos_train_steps(cfg), batch,
                                cfg.SEMISUPNET.BURN_UP_STEP, device)
    mutual_metrics = [m for is_mutual, m in history if is_mutual]
    check_ema("fcos", cfg, mutual_metrics)
    if not any(m["num_nms_candidates"] > 0 and m["num_pseudo_cls"] > 0
               and m["num_pseudo_reg"] > 0 for m in mutual_metrics):
        raise AssertionError("no mutual step had NMS candidates and pseudo boxes")
    if counts["nms"] != 2 * MUTUAL_STEPS:
        raise AssertionError(f"NMS launched {counts['nms']} times, expected {2 * MUTUAL_STEPS}")
    missing = [k for k in FCOS_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the FCOS path: {missing}")
    return counts


# --------------------------------------------------------------------------
# Faster R-CNN reference phase: kernels on the card vs plain versions on the CPU
# --------------------------------------------------------------------------


def rcnn_small_batch(cfg):
    """The CPU tests' R-CNN batch: 2 + 2 seeded 64x64 images, gt (2 boxes on
    image 0, 3 on image 1), an oracle pseudo set with teacher-like scores and
    boundary logits, strong draws that apply nothing, and sampling draws."""
    import numpy as np
    import torch

    from ubteacher_tpu_torch.data.augment import ERASE_PASSES, StrongAugParams
    from ubteacher_tpu_torch.engine.rcnn_trainer import SamplingDraws
    from ubteacher_tpu_torch.structures import PaddedInstances

    b, (h, w) = 2, RCNN_SMALL_CANVAS
    rng = np.random.default_rng(100)

    def instances(m, teacher_like):
        boxes = np.zeros((b, m, 4), np.float32)
        boxes[:, 0] = [6, 8, 40, 38]
        boxes[:, 1] = [24, 20, 60, 58]
        boxes[1, 2] = [2, 30, 22, 62]
        mask = np.zeros((b, m), bool)
        mask[0, :2] = True
        mask[1, :3] = True
        classes = rng.integers(0, 3, (b, m))
        scores = rng.uniform(0.7, 1.0, (b, m)) if teacher_like else np.ones((b, m))
        std = rng.normal(-2.0, 1.5, (b, m, 4)) if teacher_like else np.zeros((b, m, 4))
        return PaddedInstances(torch.from_numpy(boxes), torch.from_numpy(classes).long(),
                               torch.from_numpy(scores).float(), torch.from_numpy(std).float(),
                               torch.from_numpy(mask))

    def images():
        return torch.from_numpy(rng.normal(110, 40, (b, h, w, 3)).clip(0, 255).astype(np.float32))

    n = len(ERASE_PASSES)
    identity = StrongAugParams(
        jitter=torch.ones((b, 4)), apply_jitter=torch.zeros(b, dtype=torch.bool),
        apply_gray=torch.zeros(b, dtype=torch.bool), sigma=torch.ones(b),
        apply_blur=torch.zeros(b, dtype=torch.bool), erase_box=torch.ones((b, n, 4), dtype=torch.long),
        apply_erase=torch.zeros((b, n), dtype=torch.bool), erase_noise=torch.zeros((b, n, h, w, 3)),
    )
    gen = torch.Generator().manual_seed(5)
    n_anchors = sum(rcnn_anchors(RCNN_SMALL_CANVAS, "cpu")["level_lengths"])
    n_props = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + max(cfg.TPU.MAX_GT, cfg.TPU.MAX_PSEUDO)
    return {
        "images_label_k": images(), "gt_label": instances(cfg.TPU.MAX_GT, False),
        "images_unlabel_k": images(), "gt_unlabel": instances(cfg.TPU.MAX_PSEUDO, True),
        "strong_label": identity, "strong_unlabel": identity,
        "sampling_sup": SamplingDraws(torch.rand((3 * b, 2, n_anchors), generator=gen),
                                      torch.rand((3 * b, 2, n_props), generator=gen)),
    }


def rcnn_reference_phase(device) -> None:
    import torch

    from ubteacher_tpu_torch.engine.rcnn_trainer import make_rcnn_inference_fn, make_rcnn_train_steps
    from ubteacher_tpu_torch.modeling.fcos_outputs import threshold_pseudo_labels

    cfg = load_cfg(RCNN_SMALL_OPTS, RCNN_CFG)
    batch = rcnn_small_batch(cfg)
    _, mutual = make_rcnn_train_steps(cfg)  # turns TF32 off for matmuls and convolutions
    infer = make_rcnn_inference_fn(cfg)
    cpu = torch.device("cpu")
    runs = []
    for dev in (cpu, device):
        state = build_rcnn_state(cfg, dev, seed=0, cls_bias=2.5)
        state.step = cfg.SEMISUPNET.BURN_UP_STEP
        on_dev = {k: to_device(v, dev) for k, v in batch.items()}
        _, m = mutual(state, on_dev)
        # the teacher branch; at the boundary the teacher holds the initial weights
        hw = torch.tensor([RCNN_SMALL_CANVAS, (56, 48)], dtype=torch.float32, device=dev)
        dets = infer(state.teacher, on_dev["images_unlabel_k"], hw)
        pseudo = threshold_pseudo_labels(dets, cfg.SEMISUPNET.BBOX_THRESHOLD, cfg.TPU.MAX_PSEUDO)
        runs.append(({k: float(v) for k, v in m.items()}, [to_device(x, cpu) for x in (dets, pseudo)]))
    (ref, ref_dets), (got, got_dets) = runs
    log("rcnn reference phase (cpu plain vs cuda kernels):",
        {k: (round(ref[k], 6), round(got[k], 6)) for k in ref})
    agree("rcnn reference phase", got, ref,
          ("num_proposals", "num_rpn_samples", "num_roi_samples", "num_roi_fg", "num_pseudo"))
    # detections: the kept set and classes equal; boxes within 5e-3 px (the
    # CPU tests' bound for 1e-5 relative stage differences), scores and
    # boundary logits within 1e-4
    for t, r, what in zip(got_dets, ref_dets, ("detections", "pseudo labels")):
        if not (torch.equal(t.mask, r.mask) and torch.equal(t.classes, r.classes)):
            raise AssertionError(f"rcnn reference phase: {what} differ in their kept set or classes")
        for k, tol in (("boxes", 5e-3), ("scores", 1e-4), ("box_std", 1e-4)):
            err = float((getattr(t, k) - getattr(r, k)).abs().max())
            if err > tol:
                raise AssertionError(f"rcnn reference phase: {what} {k} max abs err {err}")
        log(f"rcnn reference phase: {what} {r.mask.sum(-1).tolist()} per image agree")
    if int(ref_dets[1].mask.sum()) <= 0:
        raise AssertionError("rcnn reference phase: the teacher produced no pseudo boxes")


# --------------------------------------------------------------------------
# Faster R-CNN slice phase
# --------------------------------------------------------------------------

# Launches of each R-CNN kernel over 1 burn-in + MUTUAL_STEPS fused mutual
# steps (engine/rcnn_trainer.py). Burn-in: one student forward (NMS of its
# proposals, the matcher, ROIAlign forward and backward) and one rpn_losses
# (two take_rows, whose backwards are row scatters). Each mutual step adds
# the teacher (NMS of its proposals, ROIAlign forward, the box head's NMS in
# fast_rcnn_inference) and rpn_losses runs once per branch slice
# (supervised, pseudo) of the fused forward.
RCNN_EXPECTED = {
    "nms": 1 + 3 * MUTUAL_STEPS,
    "matcher": 1 + MUTUAL_STEPS,
    "roi_align_fwd": 1 + 2 * MUTUAL_STEPS,
    "roi_align_bwd": 1 + MUTUAL_STEPS,
    "row_scatter": 2 + 4 * MUTUAL_STEPS,
}


def rcnn_slice_phase(device):
    import torch

    from ubteacher_tpu_torch.engine.rcnn_trainer import make_rcnn_train_steps

    cfg = load_cfg(["SEMISUPNET.BURN_UP_STEP", "1"], RCNN_CFG)
    state = build_rcnn_state(cfg, device, seed=0, cls_bias=RCNN_SLICE_CLS_BIAS)
    n_params = sum(p.numel() for p in state.student.parameters())
    batch = synthetic_batch(cfg, BATCH_LABEL, BATCH_UNLABEL, CANVAS,
                            torch.Generator(device=device).manual_seed(1), device,
                            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    batch["rng"] = torch.Generator(device=device).manual_seed(2)
    log(f"rcnn slice: R-{cfg.MODEL.RESNETS.DEPTH}-FPN Faster R-CNN, {cfg.MODEL.ROI_HEADS.NUM_CLASSES} "
        f"classes, {cfg.MODEL.ROI_HEADS.LOSS}, {n_params} parameters, canvas {CANVAS}, "
        f"{BATCH_LABEL}+{BATCH_UNLABEL} images, compute {cfg.TPU.COMPUTE_DTYPE}")

    history, counts = run_slice("rcnn", state, make_rcnn_train_steps(cfg), batch,
                                cfg.SEMISUPNET.BURN_UP_STEP, device)
    mutual_metrics = [m for is_mutual, m in history if is_mutual]
    check_ema("rcnn", cfg, mutual_metrics)
    if not any(m["num_pseudo"] > 0 for m in mutual_metrics):
        raise AssertionError("rcnn: no mutual step had pseudo boxes")
    expected = dict.fromkeys(counts, 0)
    expected.update(RCNN_EXPECTED)
    if counts != expected:
        raise AssertionError(f"rcnn launches {counts}, expected {expected}")
    return counts


def main() -> int:
    # Triton's compile cache stays inside the checkout, beside the nvcc build
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "ubteacher_tpu_torch", "_build", "triton"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name_power = gpu_name_and_power()
    log(name_power)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    build_kernels()

    counts = {}
    phases = (("kernel", kernel_phase), ("fcos reference", reference_phase), ("fcos slice", slice_phase),
              ("rcnn reference", rcnn_reference_phase), ("rcnn slice", rcnn_slice_phase))
    for name, phase in phases:
        t0 = time.perf_counter()
        out = phase(device)
        torch.cuda.empty_cache()
        log(f"{name} phase {time.perf_counter() - t0:.1f} s")
        if name == "kernel":
            kernels = out
        elif out is not None:
            for k, v in out.items():
                counts[k] = counts.get(k, 0) + v

    for k in kernels:
        k["launches"] = counts[k["name"]]
        k.pop("ms_f32", None)  # logged in the kernel phase; the JSON line holds the main path's dtype
    log(name_power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
