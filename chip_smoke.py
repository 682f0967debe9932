#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ubteacher_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # the whole run below
    python3 chip_smoke.py --profile-rcnn   # the R-CNN mutual step under torch.profiler
    python3 chip_smoke.py --profile-fcos   # the FCOS mutual step under torch.profiler
    python3 chip_smoke.py --lift           # the FCOS lift (phase 12) and the R-CNN ablation
    python3 chip_smoke.py --ab-stem        # TPU.STEM_MODE conv against pallas on both steps
    python3 chip_smoke.py --mfu            # the FLOP count and MFU of both mutual steps
    python3 chip_smoke.py --data-parallel  # phase 13 alone
    python3 chip_smoke.py --tools          # phase 14 alone

1. Setup: prints the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and builds the hand-written kernels from this checkout's
   sources (one nvcc per CUDA source, all started together; the Triton
   kernels compile at their first launch) and the native COCO matcher (g++).
2. Kernel phase: each kernel against its plain PyTorch version at the main
   paths' shapes. A time is the median of 20 samples, each a run of
   back-to-back calls (about 10 ms of work, behind one untimed call) over
   its count: the device's time per call, not the host's launch overhead.
   FCOS: NMS 8 images x 5000 class-offset candidates, t = 0.6, and at the
   student RPN's shape (120 rows x 2,000, t = 0.7: `ms_rpn`), its mask and
   sweep kernels timed apart (torch.profiler, logged), on edge cases (valid
   counts 0, 1, 63, 64, 65 and K, a staircase chain across tiles), two
   launches bitwise equal and free of host syncs; focal forward and
   backward (343776, 80); the GIoU forward and backward at 343776 rows (the
   upstream gradient stride 0, as rows.sum() hands it back) and on edge
   sets (random, ties in 1, 2 and 4 coordinates, ac == 0, weight 0, inf and
   NaN preds at weight 0 and above; NaN positions equal to the plain
   versions'), the backward also against autograd of the plain forward,
   both two launches bitwise equal and free of host syncs, each with its
   device time (torch.profiler, `device_ms`) and host time per call
   (`host_ms`) beside the back-to-back `ms`. Faster R-CNN: the anchor
   matcher over 257,796 anchors x (24, 100) gt slots, bitwise, with and
   without the low-quality promotion, also at the R-CNN step's mix
   (`ms_step`: images 16-23 with all 100 slots valid) and on edge cases
   (-0.0, duplicated, zero-area, off-canvas, canvas-covering and
   non-finite gts, an image with no valid slot); ROIAlign
   forward and backward over p2-p5 of 24 images, 256 channels, 512 rois per
   image (float32 and bfloat16; both also on rois crowded around 20 objects
   per image; the forward's output contiguous (N, P, P, C), and on border,
   degenerate, NaN, sampling-ratio-2, oversized (its direct path), P 5 and
   96-channel rois; both two launches bitwise equal and free of host
   syncs); the row scatter
   (24, 320, 3) and (24, 320, 12) into 85,932 rows, with 40 duplicate rows
   per image (two launches bitwise equal; timed in 5 rounds beside
   `index_add_`, with its device time). Evaluation: the fused stem over 8
   images at 800x1344 and 1344x800, float32 and bfloat16, read in place from
   an NCHW batch (a contiguous NHWC copy and the ResNet "pallas" stem must
   give the same bits), at 799x1343 and 5x3 with B = 1 and with non-finite
   pixels, timed alone and as the model calls it (`ms_call`), beside the
   port's conv-mode stem; the bf16 kernel's SASS must hold tensor-core
   instructions. Each row also carries the card's bound for the same work
   and, where one PyTorch call computes the same function, that call's time.
3. FCOS reference phase: one mutual step at a small size (the CPU parity
   tests' configuration) on the card through the kernels and on the CPU
   through the plain versions, from the same weights, batch and augmentation
   draws; the metrics must agree.
4. FCOS slice phase: configs/FCOS/coco-standard/fcos_R_50_ut2_sup1_run0.yaml
   at full R-50 width with 80 classes, canvas 768x1344, 8 labeled + 8
   unlabeled images, random weights from a seed: one burn-in step, the
   boundary copy, and three mutual steps, with the FCOS kernels' launch
   counts taken over exactly that run; then one more mutual step under
   FlopCounterMode (ubteacher_tpu_torch/tools/mfu.py): each timed mutual
   step's MFU, its FLOPs over its seconds over the card's dense-bf16 peak
   (989 TFLOP/s for an H100 SXM, 756 for a PCIe card, by the card's name).
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
   R-CNN kernels over that run, and the steps' MFU as in phase 4.
7. Eval reference phase: a small FCOS mutual step with the fused stem
   (TPU.STEM_MODE "pallas"), and evaluation of the small FCOS configuration
   through TestDataLoader and inference_on_dataset, each on the card and on
   the CPU from the same weights and images; detections and AP must agree.
8. FCOS eval slice: fcos_R_50_ut2_sup1_run0.yaml with the fused stem, test
   canvas 800x1344, batch 8, random weights, 64 landscape + 16 portrait
   synthetic COCO-style images through TestDataLoader + inference_on_dataset
   (as a trainer's test() drives them): AP fields, seconds per image, peak
   memory, exact launch counts; and the ground truth fed back as detections
   must score AP 100.
9. Faster R-CNN eval slice: faster_rcnn_R_50_FPN_ut2_sup1_run0.yaml with the
   fused stem and TEST.EVAL_PROPOSALS on the same images, through
   make_rcnn_inference_fn and make_rcnn_proposal_fn: AP and proposal AR
   fields, exact launch counts.

10. FCOS train loop: UBTeacherTrainer(...).train() on the card through the
   trainer's entry points at the recipe's full width (R-50, 80 classes,
   canvases 768x1344 / 1344x768 and the recipe's 1024x1344 buckets,
   MIN_SIZE_TRAIN (400, 1200) range, 8 + 8 images), fed by the two-stream
   loader (8 threads) from 48 + 48 seeded in-memory images (landscape
   480x640 and portrait 640x427, up to 12 boxes each, crowd boxes among
   them) and evaluated on 16 more: 6 iterations (burn-in 2, checkpoints at
   3 and 6, eval of teacher and student at 6), then a second trainer
   resumed from the checkpoint, which must hold the saved state bitwise,
   for 2 more iterations. Losses finite, the EMA rate at the boundary, the
   eval's AP fields, and in the resumed run no synchronizing call of the
   port's code (torch's sync debug mode) but the metrics fetch, once an
   iteration; the loader's host ms per batch alone, each iteration's time
   and data_time, peak memory.
11. Faster R-CNN train loop: the same for UBRCNNTeacherTrainer, 4 iterations
   (burn-in 1, checkpoints at 2 and 4, eval at 4) and 2 resumed.
12. FCOS lift: ubteacher_tpu_torch/tools/learning_sanity.py's supervised-only
   against SSOD ablation at tests/test_fcos_lift.py's seeded recipe (1000
   steps, burn-in 600, 128x128, 64 synthetic images of which 8 labeled,
   colour jitter 40, seed 0) through the trainers' entry points on the card;
   it must lift as that test asserts: the SSOD student and teacher above the
   supervised student on held-out AP, mean pseudo boxes a batch above 1.
13. Data parallel (ubteacher_tpu_torch.parallel; NCCL refuses two ranks on
   one device, so the two-rank parts run gloo, through host memory, with
   both ranks on the one card):
   (a) both steps (burn-in, mutual) of both trainers at the reference
   phases' small sizes, float32, the draws for the global batch injected,
   on 2 gloo ranks against one process with the whole batch on the card:
   counts equal, losses as agree() holds them, updates within 1e-2 over
   the model, the ranks' parameters bitwise equal;
   (b) the full-width FCOS recipe through the trainer's entry points on 2
   gloo ranks (global 8 + 8, 4 + 4 a rank) fed phase 10's images: burn-in,
   the boundary and two mutual steps, one checkpoint written by rank 0,
   the teacher's eval of the 16 test images split over the ranks; losses
   finite, parameters bitwise equal across ranks, both ranks' AP fields
   equal and within 0.01 AP of one process's eval of the checkpoint (0 at
   random weights), the test set's ground truth gathered from the ranks'
   shares scoring AP 100 on both, a resumed 2-rank trainer holding the
   saved state bitwise; per-iteration times and each rank's peak memory;
   (c) the recipe at world size 1 on NCCL through parallel.launch (what the
   CLI's --num-gpus launches): 2 iterations, then 2 resumed under torch's
   sync debug mode (no wait for the device but the metrics fetch), timed
   beside phase 10's resumed run (the same batches, no process group); then
   phase 4's FCOS slice steps on that rank, timed beside phase 4's.
   A rank that dies fails the launch, and a collective waits at most
   DP_TIMEOUT seconds for a silent peer.
14. Tools (ubteacher_tpu_torch/tools/, each through its entry point on the
   card): microbench_rcnn at its defaults (the R-CNN stages alone, beside
   the kernel phase's ROIAlign row), then each ROIAlign forward call of a
   full-width R-CNN mutual step recorded and timed alone on its own inputs;
   bench_loader --once at 8 threads alone and beside the FCOS mutual step
   (--concurrent-step); a 60-iteration soak of the FCOS recipe (8 + 8, its
   canvases in both orientations) whose child is killed with SIGKILL at the
   checkpoint at 40 and resumed here: the restored state's hash must equal
   the child's bit for bit and the run must reach MAX_ITER; the FCOS
   mutual step at 768x1344 and 1024x1344 fed to recipe_mix; both detectors
   exported (torch.export, 800x1344, batch 8, fused stem), loaded in a fresh
   process that imports torch and ubteacher_tpu_torch.ops only (no config
   or model code), whose detections must equal eager inference's on the
   same weights and images (masks and classes equal, boxes within 5e-3 px,
   scores within 1e-5; bitwise is reported) and which must launch the CUDA
   NMS and stem kernels, and for R-CNN the ROIAlign forward.

The kernels' launch counts in the JSON line are the sums over the slice
phases (4, 6, 8, 9), the train loops (10, 11), the lift (12), every
rank of the data-parallel phase (13) and the tools' runs in this process
and the serving processes (14; the soak's killed child is not counted).

The flags run one tool after the setup and print no result line:
--profile-rcnn (--profile-fcos) runs ubteacher_tpu_torch/tools/profile_step.py
on the slice configuration of phase 6 (phase 4): one burn-in step, the
boundary step and WALL_STEPS timed mutual steps (the step wall), then
PROFILED_STEPS mutual steps under torch.profiler: device time per step in
all, by group and by kernel, and the kernel launches per step. --lift runs
phase 12 and then the same ablation for Faster R-CNN (recorded, no pass
mark). --ab-stem runs tools/ab_stem.py, --mfu tools/mfu.py (its JSON goes to
ubteacher_tpu_torch/tools/flops_mutual.json), --data-parallel phase 13, --tools phase 14.

Prints the kernels' JSON line second to last and
{"ok": true, "device": {...}} last; exits nonzero, with no result line, on
any failure or when no CUDA device is present.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

from ubteacher_tpu_torch.tools import ab_stem, common, learning_sanity, mfu, profile_step
from ubteacher_tpu_torch.tools.common import (
    build_fcos_model,
    build_rcnn_model,
    build_rcnn_state,
    build_state,
    gpu_name_and_power,
    load_cfg,
    synthetic_batch,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG, RCNN_CFG = common.FCOS_CFG, common.RCNN_CFG
CANVAS = common.CANVAS
BATCH_LABEL = BATCH_UNLABEL = common.BATCH
MUTUAL_STEPS = 3
NMS_B, NMS_K, NMS_T = 8, 5000, 0.6
NMS_RPN_K, NMS_RPN_T = 2000, 0.7  # the student RPN's NMS: 24 images x 5 levels of 2,000 (MODEL.RPN.NMS_THRESH)
FOCAL_N, FOCAL_C = 16 * 21486, 80  # labeled strong + weak at 768x1344
GIOU_N = 16 * 21486
TIMED_RUNS = 20
SCATTER_ROUNDS = 5
# cls_logits bias for the slice: sigmoid(1.0) = 0.73 lifts the random-init
# teacher's scores past INFERENCE_TH_TRAIN (0.05) and BBOX_THRESHOLD (0.5);
# with the prior-probability bias (-4.6) a teacher on noise feeds NMS nothing
SLICE_CLS_BIAS = common.FCOS_CLS_BIAS
FCOS_KERNELS = ("nms", "focal_fwd", "focal_bwd", "giou_fwd", "giou_bwd")

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
RCNN_SLICE_CLS_BIAS = common.RCNN_CLS_BIAS
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

# evaluation: the test canvas and batch of both recipes (TPU.TEST_CANVAS,
# TPU.EVAL_BATCH); 64 landscape + 16 portrait images of COCO-like sizes give
# 10 batches, so the warm-up rule (5 batches, and the first of each canvas)
# leaves 4 timed batches
EVAL_CANVAS = (800, 1344)
EVAL_BATCH = 8
EVAL_IMAGES = ((64, (480, 640)), (16, (640, 427)))
EVAL_BATCHES = sum(-(-n // EVAL_BATCH) for n, _ in EVAL_IMAGES)
# the CPU parity tests' small FCOS configuration (tests/torch_parity.py)
FCOS_SMALL_OPTS = [
    "MODEL.RESNETS.DEPTH", "18", "MODEL.FCOS.NUM_CLASSES", "4",
    "TPU.COMPUTE_DTYPE", "float32", "TPU.MAX_GT", "4", "TPU.MAX_PSEUDO", "10",
    "TPU.NMS_CANDIDATES", "50", "SEMISUPNET.BURN_UP_STEP", "0",
]
EVAL_SUMMARY = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100")

# the train-loop phases: 48 labeled + 48 unlabeled seeded images, half
# landscape 480x640 and half portrait 640x427, and 16 test images; per
# recipe (iterations, burn-in, checkpoint period, eval period), then a resume
# with MAX_ITER raised by RESUME_STEPS
LOOP_IMAGES = ((24, (480, 640)), (24, (640, 427)), (24, (480, 640)), (24, (640, 427)),
               (12, (480, 640)), (4, (640, 427)))
LOOP_RUNS = {"fcos": (6, 2, 3, 6), "rcnn": (4, 1, 2, 4)}
RESUME_STEPS = 2
LOADER_BATCHES = 6  # timed batches of the loader alone, after one untimed
# the slice phases' mutual step times (ms), for the loop phases' log, and
# the loop phases' iteration times, for the data-parallel phase's log
SLICE_STEP_MS = {}
LOOP_ITER_MS = {}
LOOP_RESUMED_MS = {}


def log(*args) -> None:
    print(*args, flush=True)


# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM
# bytes per second, float32 on the CUDA cores and bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16_TENSOR = common.PEAK_BF16["H100 SXM"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the HBM rate and its operations over `peak`."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def same_bytes(a, b) -> bool:
    """Bitwise equality of two tensors of one dtype and shape."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def median_ms(fn, runs: int = TIMED_RUNS, sample_ms: float = 10.0) -> float:
    """Device time of one call of `fn`: the median over `runs` samples, each
    a run of back-to-back calls between two CUDA events divided by the count.
    The count makes a sample about `sample_ms` long; a run of more than one
    call is queued behind one untimed call, so that the device does not wait
    on the host's launch overhead and the sample measures the device."""
    import torch

    def timed(reps: int, lead: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if lead:
            fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    reps = max(1, min(200, math.ceil(sample_ms / max(timed(1, False), 1e-3))))
    return statistics.median(timed(reps, reps > 1) for _ in range(runs))


def build_kernels() -> None:
    from ubteacher_tpu_torch.evaluation import native
    from ubteacher_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"built {len(built)} CUDA libraries in {time.perf_counter() - t0:.2f} s "
        "(Triton kernels compile at first launch)")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("g++ could not build csrc/coco_eval_native.cpp")
    log(f"built the native COCO matcher in {time.perf_counter() - t0:.2f} s")
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


def settle_nms(sboxes, nvalid, got, ref, t) -> int:
    """Mismatched keep flags not explained by a pair whose float64 IoU lies
    within 1e-6 of the threshold t (those may round either way in float32)."""
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
        near = np.abs(iou - t) <= 1e-6
        for j in np.nonzero(diff[b])[0]:
            if not near[:j, j].any():
                unsettled += 1
    return unsettled


def rpn_nms_inputs(gen, device):
    """The student RPN's NMS call at 768x1344 (modeling/rpn.py:
    find_top_proposals): 24 images x 5 levels = NMS_RPN_ROWS rows of
    NMS_RPN_K candidates in score order, proposal-like boxes crowded around
    20 objects per image, each of its level's anchor size (32 * 2^level)
    times exp(N(0, 0.3)), aspect ratio in [1/2, 2], centre jittered by
    N(0, 0.15) of its size, clipped to the canvas; a p6 row holds 756 valid
    candidates (its 12 x 21 cells x 3 anchors), the others NMS_RPN_K."""
    import torch

    h, w = CANVAS
    b, k = RCNN_STUDENT, NMS_RPN_K
    rows, counts = [], []
    for lv in range(len(RCNN_STRIDES)):
        stride = RCNN_STRIDES[lv]
        centre = torch.rand((b, 20, 2), generator=gen, device=device) * torch.tensor([w, h], device=device)
        pick = torch.randint(0, 20, (b, k), generator=gen, device=device)
        size = 32 * 2**lv * torch.exp(torch.randn((b, k), generator=gen, device=device) * 0.3)
        ctr = torch.gather(centre, 1, pick[..., None].expand(-1, -1, 2))
        ctr = ctr + torch.randn((b, k, 2), generator=gen, device=device) * 0.15 * size[..., None]
        ratio = torch.exp((torch.rand((b, k), generator=gen, device=device) * 2 - 1) * math.log(2))
        half = torch.stack([size * ratio.sqrt(), size / ratio.sqrt()], -1) / 2
        boxes = torch.cat([ctr - half, ctr + half], -1)
        lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=device)
        rows.append(torch.minimum(boxes.clamp_min(0.0), lim))
        counts.append(min(k, (h // stride) * (w // stride) * 3))
    sboxes = torch.stack(rows, 1).reshape(b * len(rows), k, 4).contiguous()
    nvalid = torch.tensor(counts, dtype=torch.int32, device=device).repeat(b)
    return sboxes, nvalid


def nms_edge_cases(gen, device):
    """(name, sboxes, nvalid, t) on which the kernel must keep exactly the
    plain version's set: valid counts 0, 1, 63, 64, 65 and K in one call of
    K = 200 clustered candidates (not a multiple of 64); and a staircase of
    300 boxes 12 px apart and 100 px wide (neighbours overlap at IoU 0.79,
    boxes two apart at 0.61), so at t 0.7 greedy keeps every other box and
    the chain runs through all five tiles, K = 300 in a row of 320."""
    import torch

    k = 200
    centres = torch.rand((6, 8, 2), generator=gen, device=device) * 300.0
    pick = torch.randint(0, 8, (6, k), generator=gen, device=device)
    ctr = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2))
    ctr = ctr + torch.randn((6, k, 2), generator=gen, device=device) * 6.0
    wh = torch.rand((6, k, 2), generator=gen, device=device) * 40.0 + 10.0
    clustered = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).contiguous()
    counts = torch.tensor([0, 1, 63, 64, 65, k], dtype=torch.int32, device=device)
    x = torch.arange(320, dtype=torch.float32, device=device) * 12.0
    stair = torch.stack([x, torch.zeros_like(x), x + 100.0, torch.full_like(x, 100.0)], -1)[None].contiguous()
    return [("valid counts 0/1/63/64/65/K, K=200", clustered, counts, 0.6),
            ("staircase 300 of 320", stair, torch.tensor([300], dtype=torch.int32, device=device), 0.7)]


def kernel_split_ms(fn, calls: int = 20) -> dict:
    """Device time per call of each kernel `fn` launches: torch.profiler's
    device rows over `calls` calls, after one untimed call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0}


def check_nms(name, sboxes, nvalid, t) -> int:
    """The kernel against the plain version (no unsettled mismatch) and
    against itself (two launches bitwise equal). Returns the mismatches."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import nms_cuda

    got = nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, t)
    again = nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, t)
    ref = nms_cuda.nms_sorted_keep_plain(sboxes, nvalid, t)
    torch.cuda.synchronize()
    unsettled = settle_nms(sboxes, nvalid, got, ref, t)
    log(f"nms {name}: {tuple(sboxes.shape[:2])} t {t}, valid {int(nvalid.sum())} kept {int(got.sum())} "
        f"mismatches {int((got != ref).sum())} unsettled {unsettled}")
    if unsettled:
        raise AssertionError(f"NMS {name}: the kernel disagrees with its plain version on {unsettled} candidates")
    if not same_bytes(got, again):
        raise AssertionError(f"NMS {name}: two launches on the same inputs differ")
    return unsettled


def nms_row(device, gen) -> dict:
    import torch

    from ubteacher_tpu_torch.ops.kernels import nms_cuda

    for name, sb, nv, t in nms_edge_cases(gen, device):
        check_nms(name, sb, nv, t)
    sboxes, nvalid = nms_inputs(*clustered_boxes(gen, device))
    unsettled = check_nms("FCOS shape", sboxes, nvalid, NMS_T)
    rpn_boxes, rpn_valid = rpn_nms_inputs(gen, device)
    check_nms("RPN shape", rpn_boxes, rpn_valid, NMS_RPN_T)
    assert_no_host_sync("nms", lambda: nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, NMS_T))
    for name, (sb, nv, t) in (("FCOS shape", (sboxes, nvalid, NMS_T)), ("RPN shape", (rpn_boxes, rpn_valid, NMS_RPN_T))):
        split = kernel_split_ms(lambda: nms_cuda.nms_sorted_keep_kernel(sb, nv, t))
        log(f"nms {name}: " + ", ".join(f"{k.split('(')[0].split('::')[-1]} {v:.4f} ms" for k, v in split.items()))
    keep = nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, NMS_T)
    return {
        "name": "nms", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/nms.cu",
        "replaces": "ubteacher_tpu/ops/pallas/nms_pallas.py:203",
        "max_abs_err": float(unsettled),
        "ms": median_ms(lambda: nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, NMS_T)),
        "plain_ms": median_ms(lambda: nms_cuda.nms_sorted_keep_plain(sboxes, nvalid, NMS_T)),
        "ms_rpn": median_ms(lambda: nms_cuda.nms_sorted_keep_kernel(rpn_boxes, rpn_valid, NMS_RPN_T)),
        # the overlap test of every pair of valid candidates, ~12 float32
        # operations each
        **bound(nbytes(sboxes, nvalid, keep), 12 * float((nvalid.double() * (nvalid.double() - 1) / 2).sum()),
                PEAK_F32),
        "library_ms": None,
    }


def fcos_kernel_rows(device, gen):
    import torch

    from ubteacher_tpu_torch.ops import losses
    from ubteacher_tpu_torch.ops.kernels import focal_triton

    results = [nms_row(device, gen)]

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
        **bound(nbytes(x, t, fwd), 15 * x.numel(), PEAK_F32),  # ~15 float32 operations per element
        "library_ms": None,
    })
    results.append({
        "name": "focal_bwd", "route": "triton",
        "source": "ubteacher_tpu_torch/ops/kernels/_focal_jit.py",
        "replaces": "ubteacher_tpu/ops/pallas/focal_pallas.py:33",
        "max_abs_err": float((bwd - bwd_ref).abs().max()),
        "ms": median_ms(lambda: focal_triton.focal_backward_kernel(x, t, g, 0.25, 2.0)),
        "plain_ms": median_ms(lambda: losses.sigmoid_focal_loss_grad(x, t, g, 0.25, 2.0)),
        **bound(nbytes(x, t, g, bwd), 25 * x.numel(), PEAK_F32),
        "library_ms": None,
    })

    return results + giou_kernel_rows(device, gen)


def giou_edge_sets(gen, device, n=4133):
    """(name, pred, target, weight) rows of the edge sets of
    tests/test_torch_giou.py, n rows each (not a multiple of the block):
    random; pred equal to target in 1, 2 and 4 coordinates (ties); every
    coordinate 0 and zero widths (ac == 0); half the weights 0; an inf, -inf
    or NaN pred coordinate in every row, at weight 0 and half at weight > 0."""
    import torch

    def ltrb():
        return torch.rand((n, 4), generator=gen, device=device) * 10.0 + 0.5

    sets = []
    for name in ("random", "tie1", "tie2", "tie4", "ac0", "ac0_width", "weight0", "nonfinite_w0", "nonfinite_w"):
        p, t = ltrb(), ltrb()
        w = torch.rand((n,), generator=gen, device=device)
        if name.startswith("tie"):
            order = torch.rand((n, 4), generator=gen, device=device).argsort(-1)
            tie = torch.zeros((n, 4), dtype=torch.bool, device=device).scatter_(1, order[:, :int(name[3:])], True)
            t = torch.where(tie, p, t)
        elif name == "ac0":
            p.zero_()
            t.zero_()
        elif name == "ac0_width":
            p[:, [0, 2]] = 0.0
            t[:, [0, 2]] = 0.0
        elif name == "weight0":
            w[::2] = 0.0
        elif name.startswith("nonfinite"):
            i = torch.arange(n, device=device)
            bad = torch.tensor([math.inf, -math.inf, math.nan], device=device)[(i // 4) % 3]
            p[i, i % 4] = bad
            w[::2] = 0.0
            if name == "nonfinite_w0":
                w.zero_()
        sets.append((name, p.contiguous(), t.contiguous(), w))
    return sets


def check_giou_grad(name, p, t, w, g) -> float:
    """The backward kernel against giou_rows_grad_plain (NaN positions equal,
    rtol 1e-5 / atol 1e-6) and against autograd of giou_rows_plain: equal
    where both are finite, and NaN wherever autograd is NaN (the kernel, as
    jax.grad, also gives NaN where autograd's masked_fill gives a minimum's
    or maximum's losing side 0 against a NaN gradient). Two launches bitwise
    equal. Returns the max abs error against the plain version."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import giou_cuda

    got = giou_cuda.giou_rows_grad_kernel(p, t, w, g)
    again = giou_cuda.giou_rows_grad_kernel(p, t, w, g)
    ref = giou_cuda.giou_rows_grad_plain(p, t, w, g)
    with torch.enable_grad():
        leaf = p.detach().requires_grad_(True)
        (auto,) = torch.autograd.grad(giou_cuda.giou_rows_plain(leaf, t, w), leaf, g)
    torch.cuda.synchronize()
    if not same_bytes(got, again):
        raise AssertionError(f"giou_bwd {name}: two launches on the same inputs differ")
    if not torch.equal(got.isnan(), ref.isnan()) or not torch.allclose(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True):
        raise AssertionError(f"giou_bwd {name}: max abs err {float((got - ref).abs().nan_to_num().max())} "
                             f"against the plain version, NaN {int(got.isnan().sum())} vs {int(ref.isnan().sum())}")
    both = ~got.isnan() & ~auto.isnan()
    if (auto.isnan() & ~got.isnan()).any() or not torch.allclose(got[both], auto[both], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"giou_bwd {name}: disagrees with autograd of the plain forward")
    err = float((got - ref).abs().nan_to_num().max()) if got.numel() else 0.0
    log(f"giou_bwd {name}: {p.shape[0]} rows, grad stride {g.stride(0)}, max abs err {err:.3g}, bitwise equal "
        f"to plain {same_bytes(got, ref)}, NaN {int(got.isnan().sum())} (autograd {int(auto.isnan().sum())}), "
        f"max abs err to autograd {float((got[both] - auto[both]).abs().max()) if both.any() else 0.0:.3g}")
    return err


def host_ms(fn, calls: int = 200) -> float:
    """Host time of one call of `fn`, launches queued on an idle device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def device_ms(fn, name: str) -> float:
    """Device time per call of the kernels of `fn` whose name holds `name`."""
    return sum(ms for key, ms in kernel_split_ms(fn).items() if name in key)


def giou_kernel_rows(device, gen):
    """The GIoU forward and backward kernels against their plain versions at
    the FCOS step's GIOU_N rows and on the edge sets; back-to-back ms,
    device ms (torch.profiler) and host ms per call."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import giou_cuda

    for name, p, t, w in giou_edge_sets(gen, device):
        rows = giou_cuda.giou_rows_kernel(p, t, w)
        ref = giou_cuda.giou_rows_plain(p, t, w)
        torch.cuda.synchronize()
        if not torch.equal(rows.isnan(), ref.isnan()) or not torch.allclose(rows, ref, rtol=1e-5, atol=1e-6,
                                                                            equal_nan=True):
            raise AssertionError(f"giou_fwd {name}: max abs err {float((rows - ref).abs().nan_to_num().max())}")
        if not same_bytes(rows, giou_cuda.giou_rows_kernel(p, t, w)):
            raise AssertionError(f"giou_fwd {name}: two launches on the same inputs differ")
        check_giou_grad(name, p, t, w, torch.rand((p.shape[0],), generator=gen, device=device))
        check_giou_grad(name, p, t, w, torch.ones((), device=device).expand(p.shape[0]))
    empty = torch.empty((0, 4), device=device)
    before = dict(giou_cuda.LAUNCHES)
    if (giou_cuda.giou_rows_kernel(empty, empty, empty[:, 0].contiguous()).shape != (0,)
            or giou_cuda.giou_rows_grad_kernel(empty, empty, empty[:, 0].contiguous(),
                                               empty[:, 0].contiguous()).shape != (0, 4)
            or giou_cuda.LAUNCHES != before):
        raise AssertionError("giou: 0 rows must give empty outputs and no launch")

    # the FCOS step's rows: positives-like boxes, ctrness-like weights, and
    # the upstream gradient as rows.sum() hands it back (stride 0)
    p = torch.rand((GIOU_N, 4), generator=gen, device=device) * 12.0 + 0.05
    q = torch.rand((GIOU_N, 4), generator=gen, device=device) * 12.0 + 0.05
    w = torch.rand((GIOU_N,), generator=gen, device=device)
    g = torch.ones((), device=device).expand(GIOU_N)
    rows = giou_cuda.giou_rows_kernel(p, q, w)
    rows_ref = giou_cuda.giou_rows_plain(p, q, w)
    torch.cuda.synchronize()
    if not torch.allclose(rows, rows_ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"giou_fwd: max abs err {float((rows - rows_ref).abs().max())}")
    if not same_bytes(rows, giou_cuda.giou_rows_kernel(p, q, w)):
        raise AssertionError("giou_fwd: two launches on the same inputs differ")
    bwd_err = check_giou_grad("FCOS shape", p, q, w, g)
    dp = giou_cuda.giou_rows_grad_kernel(p, q, w, g)
    assert_no_host_sync("giou_fwd", lambda: giou_cuda.giou_rows_kernel(p, q, w))
    assert_no_host_sync("giou_bwd", lambda: giou_cuda.giou_rows_grad_kernel(p, q, w, g))

    def autograd_bwd():
        leaf = p.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(giou_cuda.giou_rows_plain(leaf, q, w), leaf, g)

    fwd = lambda: giou_cuda.giou_rows_kernel(p, q, w)  # noqa: E731
    bwd = lambda: giou_cuda.giou_rows_grad_kernel(p, q, w, g)  # noqa: E731
    out = []
    for name, fn, plain, replaces, moved, ops in (
        ("giou_fwd", fwd, lambda: giou_cuda.giou_rows_plain(p, q, w), 52, nbytes(p, q, w, rows), 30),
        # the stride-0 gradient is one float read
        ("giou_bwd", bwd, lambda: giou_cuda.giou_rows_grad_plain(p, q, w, g), 85, nbytes(p, q, w, dp) + 4, 70),
    ):
        row = {
            "name": name, "route": "cuda", "source": "ubteacher_tpu_torch/csrc/giou.cu",
            "replaces": f"ubteacher_tpu/ops/pallas/giou_pallas.py:{replaces}",
            "max_abs_err": float((rows - rows_ref).abs().max()) if name == "giou_fwd" else bwd_err,
            "ms": median_ms(fn), "device_ms": device_ms(fn, name), "host_ms": host_ms(fn),
            "plain_ms": median_ms(plain),
            **bound(moved, ops * GIOU_N, PEAK_F32),
            "library_ms": None,
        }
        out.append(row)
    log(f"giou_bwd: autograd of the plain forward (the Triton route's backward) "
        f"{median_ms(autograd_bwd):.4f} ms back to back, device ms by kernel "
        f"{sum(kernel_split_ms(autograd_bwd).values()):.4f}")
    for r in out:
        share = f"{100 * r['bound_ms'] / r['device_ms']:.0f}%" if r["device_ms"] > 0 else "not measured"
        log(f"{r['name']}: back to back {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
            f"(bound / device: {share}), host {r['host_ms']:.4f} ms a call")
    return out


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


def clustered_rois(gen, device, b, r, centres=20):
    """(b * r, 4) rois drawn around `centres` objects per image, as an RPN's
    proposals crowd around objects: each object has a centre on the canvas
    and a size log-uniform in [12, 900] px; each roi takes its object's size
    times exp(N(0, 0.25)) (aspect ratio in [1/2, 2]) and its centre jittered
    by N(0, 0.1) of that size; clipped to the canvas. The rois of one object
    fall on one level and a few tiles, which the backward's tile-owning
    blocks see as load imbalance."""
    import torch

    h, w = CANVAS
    obj_ctr = torch.rand((b, centres, 2), generator=gen, device=device) * torch.tensor([w, h], device=device)
    obj_size = torch.exp(torch.rand((b, centres), generator=gen, device=device) * math.log(900 / 12)) * 12
    pick = torch.randint(0, centres, (b, r), generator=gen, device=device)
    size = torch.gather(obj_size, 1, pick) * torch.exp(torch.randn((b, r), generator=gen, device=device) * 0.25)
    ctr = torch.gather(obj_ctr, 1, pick[..., None].expand(-1, -1, 2))
    ctr = ctr + torch.randn((b, r, 2), generator=gen, device=device) * 0.1 * size[..., None]
    ratio = torch.exp((torch.rand((b, r), generator=gen, device=device) * 2 - 1) * math.log(2))
    half = torch.stack([size * ratio.sqrt(), size / ratio.sqrt()], -1) / 2
    boxes = torch.cat([ctr - half, ctr + half], -1).reshape(b * r, 4)
    lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=device)
    return torch.minimum(torch.maximum(boxes, torch.zeros((), device=device)), lim).contiguous()


def assert_no_host_sync(name, fn) -> None:
    """Fails if `fn` waits for the device: queued behind about 57 ms of
    device spin (1e8 cycles), one call must return on the host long before
    the spin ends."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"{name}: {host_ms:.2f} ms of host time behind a busy device")
    if host_ms > 20.0:
        raise AssertionError(f"{name} waits for the device ({host_ms:.1f} ms of host time behind a busy device)")


def check_roi_fwd(name, feats, feats16, args, nan_rois=()):
    """The forward kernel in float32 and bf16 against the plain version on
    the same inputs, and two bf16 launches against each other, bitwise; the
    output must be contiguous (N, P, P, C) in the feature dtype. The rois
    `nan_rois` (a level out of range) must come out NaN in both; the others
    are compared.
    Returns (max abs err float32, bf16)."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import roi_align_cuda

    boxes, level, r, scales, p, sr = args
    n, c = boxes.shape[0], feats[0].shape[1]
    ok = torch.ones(n, dtype=torch.bool, device=boxes.device)
    ok[list(nan_rois)] = False
    out32 = roi_align_cuda.roi_align_forward_kernel(feats, *args)
    ref32 = roi_align_cuda.roi_align_plain(feats, *args)
    out16 = roi_align_cuda.roi_align_forward_kernel(feats16, *args)
    again16 = roi_align_cuda.roi_align_forward_kernel(feats16, *args)
    ref16 = roi_align_cuda.roi_align_plain(feats16, *args)
    torch.cuda.synchronize()
    for out, dtype in ((out32, torch.float32), (out16, torch.bfloat16)):
        if out.shape != (n, p, p, c) or out.dtype != dtype or not out.is_contiguous():
            raise AssertionError(f"{name}: output {out.dtype} {tuple(out.shape)} stride {out.stride()}, "
                                 f"expected contiguous {dtype} {(n, p, p, c)}")
    if not all(bool(t[~ok].isnan().all()) for t in (out32, out16, ref32, ref16)):
        raise AssertionError(f"{name}: a roi with its level out of range is not NaN")
    # accumulated in float32 in both; the sums run in other orders (rtol
    # 1e-5), and in bfloat16 each result is rounded once, so the two may sit
    # one bf16 ulp (2^-7 relative) apart
    a32, r32, a16, r16 = out32[ok], ref32[ok], out16[ok].float(), ref16[ok].float()
    err32 = float((a32 - r32).abs().max()) if a32.numel() else 0.0
    err16 = float((a16 - r16).abs().max()) if a16.numel() else 0.0
    log(f"{name}: {n} rois, P {p}, sampling_ratio {sr}, C {c}: max abs err float32 {err32:.3g}, bfloat16 "
        f"{err16:.3g} (|out| max {float(r32.abs().max()) if r32.numel() else 0.0:.3g}); two bf16 launches "
        f"bitwise equal: {same_bytes(out16, again16)}")
    if not torch.allclose(a32, r32, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name} float32: max abs err {err32}")
    if not torch.allclose(a16, r16, rtol=2**-7, atol=1e-5):
        raise AssertionError(f"{name} bfloat16: max abs err {err16}")
    if not same_bytes(out16, again16):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    return err32, err16


def check_roi_fwd_edges(device, gen, feats, feats16, scales) -> None:
    """The forward on the edges of its input domain, on the first two images
    of the kernel phase's levels: rois on and across the canvas border,
    degenerate rois (zero extent), a NaN box (its level out of range: NaN
    out), sampling_ratio 2, rois whose footprint exceeds the staging budget
    (the whole canvas and a thin full-width strip, pooled from p2: the
    kernel's direct path), P = 5, and 96 channels (not a multiple of the
    64-channel chunk)."""
    import torch

    from ubteacher_tpu_torch.ops.roi_align import assign_levels

    h, w = CANVAS
    two = [f[:2].contiguous() for f in feats]
    two16 = [f[:2].contiguous() for f in feats16]
    r = 16
    rand = rcnn_rois(gen, device, 2, r)

    def levels(bx):
        return (assign_levels(bx, 2, 5) - 2).contiguous()

    edge = torch.tensor([[-40, -30, 120, 90], [w - 50, h - 20, w + 60, h + 10], [0, 0, w, h], [-200, -200, -20, -20],
                         [w - 0.5, 10, w + 0.5, 11.5], [300, 0, 700, 1], [0, 500, 3, h], [w + 5, h + 5, w + 90, h + 80]],
                        dtype=torch.float32, device=device)
    degenerate = torch.tensor([[30, 30, 30, 30], [10.5, 20.25, 10.5, 50], [640, 0, 900, 0], [w - 1, h - 1, w - 1, h - 1]],
                              dtype=torch.float32, device=device)
    border = torch.cat([edge, degenerate, rand[:2 * r - 12]]).contiguous()
    nan = rand.clone()
    nan[3] = float("nan")
    big = rand.clone()
    big[:4] = torch.tensor([[0, 0, w, h], [0, 300, w, 310], [-100, -100, w + 100, h + 100], [0, 0, 700, h]],
                           dtype=torch.float32, device=device)
    big_level = levels(big)
    big_level[:4] = 0  # pooled from p2: a footprint of up to 192 x 336 pixels
    nan_level = levels(nan)
    if int(nan_level[3]) in range(len(scales)):
        raise AssertionError(f"the NaN box was assigned level {int(nan_level[3])}")
    for name, (bx, lv, p, sr), nan_rois in (
            ("border and degenerate", (border, levels(border), 7, 0), ()),
            ("NaN box", (nan, nan_level, 7, 0), (3,)),
            ("sampling_ratio 2", (rand, levels(rand), 7, 2), ()),
            ("direct path", (big, big_level.contiguous(), 7, 0), ()),
            ("P 5", (rand, levels(rand), 5, 0), ())):
        check_roi_fwd(f"roi_align_fwd {name}", two, two16, (bx, lv, r, scales, p, sr), nan_rois)
    narrow = [f[:, :96].contiguous() for f in two]
    check_roi_fwd("roi_align_fwd 96 channels", narrow, [f.bfloat16() for f in narrow],
                  (rand, levels(rand), r, scales, 7, 0))


def check_roi_bwd(name, feats, feats16, args, grad, grad16):
    """The backward kernel in float32 and bf16 against the plain backward,
    and two bf16 launches against each other, bitwise. Returns (max abs err
    float32, bf16)."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import roi_align_cuda

    leaves = [f.clone().requires_grad_(True) for f in feats]
    ref_g = torch.autograd.grad(roi_align_cuda.roi_align_plain(leaves, *args), leaves, grad)
    got_g = roi_align_cuda.roi_align_backward_kernel(grad, feats, *args)
    # bf16: the kernel on bf16 features and gradient against the plain
    # backward in float32 on the same (upcast) values, rounded once
    leaves16 = [f.float().requires_grad_(True) for f in feats16]
    ref_g16 = torch.autograd.grad(roi_align_cuda.roi_align_plain(leaves16, *args), leaves16, grad16.float())
    got_g16 = roi_align_cuda.roi_align_backward_kernel(grad16, feats16, *args)
    again16 = roi_align_cuda.roi_align_backward_kernel(grad16, feats16, *args)
    torch.cuda.synchronize()
    err32 = err16 = 0.0
    for lv, (a32, r32, a16, r16, b16) in enumerate(zip(got_g, ref_g, got_g16, ref_g16, again16)):
        # the kernel sums each pixel's terms per roi through separable bin
        # weights, the plain autograd tap by tap: float32 sums in two orders,
        # 1e-5 of the level's largest gradient; bf16 adds one rounding of the
        # result (2^-7 relative)
        scale = float(r32.abs().max())
        err32 = max(err32, float((a32 - r32).abs().max()))
        err16 = max(err16, float((a16.float() - r16).abs().max()))
        if a32.dtype != torch.float32 or a16.dtype != torch.bfloat16 or not a16.is_contiguous():
            raise AssertionError(f"{name} p{lv + 2}: gradient dtype {a32.dtype}, {a16.dtype} or layout wrong")
        if not torch.allclose(a32, r32, rtol=1e-5, atol=1e-5 * scale):
            raise AssertionError(f"{name} float32 p{lv + 2}: max abs err {float((a32 - r32).abs().max())}")
        if not torch.allclose(a16.float(), r16, rtol=2**-7, atol=1e-5 * scale):
            raise AssertionError(f"{name} bfloat16 p{lv + 2}: max abs err {float((a16.float() - r16).abs().max())}")
        if not same_bytes(a16, b16):
            raise AssertionError(f"{name} p{lv + 2}: two launches on the same inputs differ")
    log(f"{name}: max abs err float32 {err32:.3g}, bfloat16 {err16:.3g} (|grad| max "
        f"{max(float(g.abs().max()) for g in ref_g):.3g}); two bf16 launches bitwise equal")
    return err32, err16


def roi_bound(boxes, level, scales, shapes, rois_per_image, channels, pooled):
    """(feature pixels some roi reads, bilinear taps): the pixels are each
    roi's sample span on its level (shifted half a pixel, clipped, widened to
    the corner pixels), united over the rois of an image with a 2-d
    difference array; a tap is one corner of one sample of one bin of one
    channel, with ceil(extent / P) samples per axis, at most 8 (sampling
    ratio 0, ops/roi_align.py)."""
    import torch

    dev = boxes.device
    sc = torch.tensor(scales, device=dev)[level.long()]
    per_axis = (((boxes[:, 2:] - boxes[:, :2]) * sc[:, None]).clamp_min(1e-6) / pooled).ceil().clamp(1, 8)
    taps = 4 * channels * pooled * pooled * float(per_axis.prod(1).sum())
    img = torch.arange(boxes.shape[0], device=dev) // rois_per_image
    n_img = boxes.shape[0] // rois_per_image
    pixels = 0
    for lv, (s, (h, w)) in enumerate(zip(scales, shapes)):
        sel = level == lv
        bx, b = boxes[sel] * s - 0.5, img[sel]
        x0, x1 = (bx[:, 0::2].clamp(0, w - 1).floor().long() + torch.tensor([0, 1], device=dev)).clamp(max=w - 1).T
        y0, y1 = (bx[:, 1::2].clamp(0, h - 1).floor().long() + torch.tensor([0, 1], device=dev)).clamp(max=h - 1).T
        diff = torch.zeros((n_img, h + 1, w + 1), dtype=torch.int32, device=dev)
        for yy, xx, v in ((y0, x0, 1), (y0, x1 + 1, -1), (y1 + 1, x0, -1), (y1 + 1, x1 + 1, 1)):
            diff.index_put_((b, yy, xx), torch.full_like(b, v, dtype=torch.int32), accumulate=True)
        pixels += int((diff.cumsum(1).cumsum(2)[:, :h, :w] > 0).sum())
    return pixels, taps


def matcher_edge_cases(device, anchors):
    """(name, gt (B, M, 4), mask (B, M)) cases the culling must keep exact:
    -0.0 coordinates, ties across duplicated gts, a gt equal to an anchor
    (IoU exactly 1), zero-area gts (a point, a vertical line), gts outside
    the canvas and covering it, non-finite gts (NaN, +-inf), an image with no
    valid slot, and slot 0 invalid before valid ones."""
    import torch

    h, w = CANVAS
    gen = torch.Generator(device=device).manual_seed(5)

    def rand_boxes(b, m):
        xy = torch.rand((b, m, 2), generator=gen, device=device) * torch.tensor([w, h], device=device)
        wh = torch.rand((b, m, 2), generator=gen, device=device) * 300 + 1
        return torch.cat([xy, xy + wh], -1)

    b, m = 6, 12
    gt = rand_boxes(b, m)
    mask = torch.ones((b, m), dtype=torch.bool, device=device)
    gt[0, 0] = torch.tensor([-0.0, -0.0, 40.0, 40.0], device=device)
    gt[0, 1] = torch.tensor([0.0, -0.0, -0.0, 50.0], device=device)
    gt[0, 3] = gt[0, 2]                                   # duplicated gt: the first slot wins ties
    gt[0, 5] = gt[0, 4]
    gt[1, 0] = anchors[4000]                              # IoU exactly 1
    gt[1, 1] = anchors[200000]
    gt[1, 2] = torch.tensor([300.0, 300.0, 300.0, 300.0], device=device)   # a point
    gt[1, 3] = torch.tensor([500.0, 100.0, 500.0, 400.0], device=device)   # a vertical line
    gt[2, 0] = torch.tensor([-500.0, -400.0, -100.0, -50.0], device=device)  # outside the canvas
    gt[2, 1] = torch.tensor([w + 10.0, 0.0, w + 900.0, h], device=device)
    gt[2, 2] = torch.tensor([0.0, 0.0, w, h], device=device)               # covers the canvas
    gt[2, 3] = torch.tensor([-2000.0, -2000.0, 4000.0, 4000.0], device=device)
    nan, inf = float("nan"), float("inf")
    gt[3, 0] = torch.tensor([nan, 10.0, 200.0, 200.0], device=device)
    gt[3, 1] = torch.tensor([10.0, 10.0, inf, 200.0], device=device)
    gt[3, 2] = torch.tensor([-inf, -inf, inf, inf], device=device)
    gt[3, 3] = torch.tensor([inf, 10.0, -inf, 200.0], device=device)
    mask[4] = False                                       # no valid slot
    mask[5, :3] = False                                   # the first valid slot is 3
    mask[5, -1] = False
    return [("edges", gt.contiguous(), mask.contiguous())]


def matcher_row(device, gen):
    """The anchor matcher, bitwise against its plain version: at the kernel
    phase's gts (matcher_gt), at the R-CNN step's mix (images 0-15 those,
    16-23 with all 100 slots valid, as the teacher's pseudo boxes fill them)
    and on edge cases; timed at both (`ms`, `ms_step`). Also logs the pairs
    the culled design computes against all valid pairs and the overlapping
    ones."""
    import torch

    from ubteacher_tpu_torch.modeling.matcher import match_quality
    from ubteacher_tpu_torch.ops.kernels import matcher_cuda

    anchors = rcnn_anchors(CANVAS, device)["anchors"]
    gt, mask = matcher_gt(gen, device, anchors)
    step_mask = mask.clone()
    step_mask[2 * BATCH_LABEL:] = True
    sets = [("kernel phase", gt, mask), ("step mix", gt, step_mask.contiguous())]
    sets += matcher_edge_cases(device, anchors)
    err = 0
    for name, g, m in sets:
        for low in (True, False):
            idx, lab = matcher_cuda.match_anchors_kernel(anchors, g, m, allow_low_quality=low)
            idx_ref, lab_ref = matcher_cuda.match_anchors_plain(anchors, g, m, allow_low_quality=low)
            torch.cuda.synchronize()
            wrong = int((idx != idx_ref).sum() + (lab != lab_ref).sum())
            if not low:
                if wrong:
                    raise AssertionError(f"matcher {name} without promotion: {wrong} entries differ")
                continue
            cand = matcher_cuda.warp_candidates(anchors, g, m)
            overlap = sum(int((match_quality(g[i:i + 1], m[i:i + 1], anchors) > 0).sum()) for i in range(g.shape[0]))
            log(f"matcher {name}: {anchors.shape[0]} anchors x {tuple(m.shape)} gt slots, valid per image "
                f"{m.sum(-1).tolist()}, positives {int((lab == 1).sum())}, ignored {int((lab == -1).sum())}, "
                f"mismatched entries {wrong}; pairs: valid {anchors.shape[0] * int(m.sum())}, computed per pass "
                f"{matcher_cuda.WARP * int(cand.sum())}, overlapping {overlap}")
            if wrong:
                raise AssertionError(f"matcher kernel differs from its plain version in {wrong} entries ({name})")
            err = max(err, int((idx - idx_ref).abs().max()) if idx.numel() else 0,
                      int((lab - lab_ref).abs().max()) if lab.numel() else 0)
            if name == "kernel phase":
                needed = overlap  # the pairs whose IoU is not 0
        del idx_ref, lab_ref
    row = {
        "name": "matcher", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/matcher.cu",
        "replaces": "ubteacher_tpu/ops/pallas/matcher_pallas.py:182",
        "max_abs_err": float(err),
        "ms": median_ms(lambda: matcher_cuda.match_anchors_kernel(anchors, gt, mask)),
        "ms_step": median_ms(lambda: matcher_cuda.match_anchors_kernel(anchors, gt, step_mask)),
        "plain_ms": median_ms(lambda: matcher_cuda.match_anchors_plain(anchors, gt, mask)),
        # the outputs written once; one IoU (~12 float32 operations) per
        # overlapping pair, the only pairs whose IoU is not 0
        **bound(nbytes(anchors, gt, mask) + 2 * 8 * mask.shape[0] * anchors.shape[0], 12 * needed, PEAK_F32),
        "library_ms": None,
    }
    torch.cuda.empty_cache()
    return row


def rcnn_kernel_rows(device, gen):
    import torch

    from ubteacher_tpu_torch.ops.kernels import roi_align_cuda, row_scatter_cuda
    from ubteacher_tpu_torch.ops.roi_align import assign_levels

    results = [matcher_row(device, gen)]

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
    err32, err16 = check_roi_fwd("roi_align_fwd", feats, feats16, args)
    assert_no_host_sync("roi_align_fwd", lambda: roi_align_cuda.roi_align_forward_kernel(feats16, *args))
    check_roi_fwd_edges(device, gen, feats, feats16, scales)
    pixels, taps = roi_bound(boxes, level, scales, [f.shape[2:] for f in feats], r, c, p)
    log(f"roi_align: {pixels} feature pixels read, {taps:.4g} bilinear taps")
    pooled16 = b * r * p * p * c * 2
    results.append({
        "name": "roi_align_fwd", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/roi_align.cu",
        "replaces": "ubteacher_tpu/ops/pallas/roi_align_pallas.py:894",
        "max_abs_err": err16,
        "ms": median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(feats16, *args)),
        "plain_ms": median_ms(lambda: roi_align_cuda.roi_align_plain(feats16, *args)),
        "ms_f32": median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(feats, *args)),
        # the feature pixels the rois read and the pooled output, bf16; a
        # multiply-add per tap on the CUDA cores
        **bound(pixels * c * 2 + nbytes(boxes, level) + pooled16, 2 * taps, PEAK_F32),
        "library_ms": None,
    })

    grad = torch.randn((b * r, p, p, c), generator=gen, device=device)
    grad16 = grad.bfloat16()
    _, err16 = check_roi_bwd("roi_align_bwd", feats, feats16, args, grad, grad16)
    assert_no_host_sync("roi_align_bwd", lambda: roi_align_cuda.roi_align_backward_kernel(grad16, feats16, *args))
    leaves = [f.clone().requires_grad_(True) for f in feats]
    plain_out = roi_align_cuda.roi_align_plain(leaves, *args)
    results.append({
        "name": "roi_align_bwd", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/roi_align.cu",
        "replaces": "ubteacher_tpu/ops/pallas/roi_align_pallas.py:531",
        "max_abs_err": err16,
        "ms": median_ms(lambda: roi_align_cuda.roi_align_backward_kernel(grad16, feats16, *args)),
        "plain_ms": median_ms(lambda: torch.autograd.grad(plain_out, leaves, grad, retain_graph=True)),
        "ms_f32": median_ms(lambda: roi_align_cuda.roi_align_backward_kernel(grad, feats, *args)),
        # the pooled gradient in, every level's feature gradient out (bf16)
        **bound(pooled16 + nbytes(boxes, level, *feats16), 2 * taps, PEAK_F32),
        "library_ms": None,
    })
    del leaves, plain_out
    # the same shapes with the rois crowded around 20 objects per image
    cboxes = clustered_rois(gen, device, b, r)
    clevel = (assign_levels(cboxes, 2, 5) - 2).contiguous()
    cargs = (cboxes, clevel, r, scales, p, 0)
    log(f"roi_align clustered: 20 objects per image, rois per level "
        f"{torch.bincount(clevel.long(), minlength=4).tolist()}")
    check_roi_fwd("roi_align_fwd clustered", feats, feats16, cargs)
    log(f"roi_align_fwd clustered: {median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(feats16, *cargs)):.4f} ms "
        f"bf16, {median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(feats, *cargs)):.4f} ms float32")
    check_roi_bwd("roi_align_bwd clustered", feats, feats16, cargs, grad, grad16)
    log(f"roi_align_bwd clustered: {median_ms(lambda: roi_align_cuda.roi_align_backward_kernel(grad16, feats16, *cargs)):.4f} ms "
        f"bf16, {median_ms(lambda: roi_align_cuda.roi_align_backward_kernel(grad, feats, *cargs)):.4f} ms float32")
    del feats, feats16, grad, grad16
    torch.cuda.empty_cache()

    # --- row scatter: the RPN gather's backward, duplicates accumulating ---
    length = sum(rcnn_anchors(CANVAS, "cpu")["level_lengths"]) // 3
    rows = torch.randint(0, length, (RCNN_STUDENT, RCNN_RPN_ROWS), generator=gen, device=device)
    rows[:, :40] = rows[:, :1]
    err = 0.0
    for d in (12, 3):
        g = torch.randn((RCNN_STUDENT, RCNN_RPN_ROWS, d), generator=gen, device=device)
        got = row_scatter_cuda.scatter_rows_kernel(g, rows, length)
        again = row_scatter_cuda.scatter_rows_kernel(g, rows, length)
        ref = row_scatter_cuda.scatter_rows_plain(g, rows, length)
        torch.cuda.synchronize()
        # float32 sums of the same terms: in k order in the kernel, in
        # index_put_'s order in the plain version
        if not torch.allclose(got, ref, rtol=1e-6, atol=1e-5):
            raise AssertionError(f"row_scatter D={d}: max abs err {float((got - ref).abs().max())}")
        if not same_bytes(got, again):
            raise AssertionError(f"row_scatter D={d}: two launches on the same inputs differ")
        err = max(err, float((got - ref).abs().max()))
        log(f"row_scatter D={d}: two launches bitwise equal; bitwise equal to the plain index_put_: "
            f"{same_bytes(got, ref)}")
    log(f"row_scatter: ({RCNN_STUDENT}, {RCNN_RPN_ROWS}, D) into {length} rows, max abs err {err:.3g}")
    assert_no_host_sync("row_scatter", lambda: row_scatter_cuda.scatter_rows_kernel(g, rows, length))
    g = torch.randn((RCNN_STUDENT, RCNN_RPN_ROWS, 12), generator=gen, device=device)
    # the library yardstick: one index_add_ into a zeroed (B * L, D) grid
    flat_rows = (rows + torch.arange(RCNN_STUDENT, device=device)[:, None] * length).reshape(-1)

    def index_add():
        return torch.zeros((RCNN_STUDENT * length, 12), device=device).index_add_(0, flat_rows, g.reshape(-1, 12))

    if not torch.allclose(index_add().view(RCNN_STUDENT, length, 12),
                          row_scatter_cuda.scatter_rows_plain(g, rows, length), rtol=1e-6, atol=1e-5):
        raise AssertionError("row_scatter: the index_add_ yardstick computes another function")
    def scatter():
        return row_scatter_cuda.scatter_rows_kernel(g, rows, length)

    # the shortest calls move most between runs: 5 rounds, kernel and
    # library in turns, and the device time of each apart
    rounds = [(median_ms(scatter), median_ms(index_add)) for _ in range(SCATTER_ROUNDS)]
    kernel_ms, library_ms = (sorted(r[i] for r in rounds) for i in (0, 1))
    split = device_ms(scatter, "scatter_rows")
    library_split = sum(kernel_split_ms(index_add).values())
    log(f"row_scatter: {SCATTER_ROUNDS} rounds back to back, kernel {[round(r[0], 4) for r in rounds]} ms "
        f"(spread {kernel_ms[-1] - kernel_ms[0]:.4f}), index_add_ {[round(r[1], 4) for r in rounds]} ms "
        f"(spread {library_ms[-1] - library_ms[0]:.4f}); device {split:.4f} ms, index_add_ device "
        f"{library_split:.4f} ms (its zero fill included)")
    results.append({
        "name": "row_scatter", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/row_scatter.cu",
        "replaces": "ubteacher_tpu/ops/pallas/row_gather_pallas.py:71",
        "max_abs_err": err,
        "ms": statistics.median(kernel_ms), "device_ms": split,
        "plain_ms": median_ms(lambda: row_scatter_cuda.scatter_rows_plain(g, rows, length)),
        **bound(nbytes(g, rows) + RCNN_STUDENT * length * 12 * 4, g.numel(), PEAK_F32),
        "library_ms": statistics.median(library_ms),
    })
    return results


def bf16_ulp(v):
    """Spacing of bfloat16 values at |v| (8 significant bits)."""
    import torch

    return torch.pow(2.0, torch.floor(torch.log2(v.abs().clamp_min(2.0**-126))) - 7)


def stem_sass_mma() -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of the fused stem's
    bf16 kernel, counted with cuobjdump from the built library."""
    from ubteacher_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path("stem")], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {"HMMA": 0, "HGMMA": 0}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif "stem_conv_pool_mma" in fn:
            for op in counts:
                counts[op] += f" {op}." in line or f" {op} " in line
    return counts


def stem_truth64(x, kernel, scale, bias):
    """The stem in float64 from the float32 folded weights: the truth the
    float32 results are held to."""
    import torch
    import torch.nn.functional as F

    k = (kernel.float() * scale.float()).double()
    acc = F.conv2d(x.double().permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=2, padding=3)
    y = torch.relu(acc + bias.double()[:, None, None])
    return F.max_pool2d(y, 3, 2, 1).permute(0, 2, 3, 1)


def check_stem(name, x, kernel, scale, bias):
    """The fused stem kernel in float32 and bf16, reading x (B, H, W, 3) at
    x's own strides, against its plain version on the same values (a
    contiguous NHWC copy: there cuDNN sums the float32 conv in the kernel's
    order, where on the NCHW view it picks another order, and two float32
    results, each within the tolerance of the float64 truth, can differ by
    twice it; port_tools/stem_f32_check.py). float32: JAX's own tolerance
    (test_stem_pallas.py), rtol 1e-5 / atol 1e-4, against the plain version
    and against the float64 truth. bf16: the float32 sum is rounded once to
    bf16 and the bias added in bf16, so an output may sit one ulp of the sum
    (|out| + |bias| bounds it) plus one ulp of the bias add from the plain
    version's. Only outputs the plain version keeps finite are compared (a
    non-finite pixel makes its windows NaN there). Returns (bf16 max abs
    err, bf16 output, float32 output, float32 plain output)."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import stem_cuda
    from ubteacher_tpu_torch.ops.stem import stem_conv_pool_plain

    b, h, w, _ = x.shape
    xc = x.contiguous()
    ref32 = stem_conv_pool_plain(xc, kernel, scale, bias, torch.float32)
    got32 = stem_cuda.stem_conv_pool_kernel(x, kernel, scale, bias, torch.float32)
    truth = stem_truth64(xc, kernel, scale, bias)
    ref16 = stem_conv_pool_plain(xc, kernel, scale, bias, torch.bfloat16).float()
    out16 = stem_cuda.stem_conv_pool_kernel(x, kernel, scale, bias, torch.bfloat16)
    got16 = out16.float()
    torch.cuda.synchronize()
    del xc
    shape = (b, -(-h // 4), -(-w // 4), 64)
    fin32, fin16 = torch.isfinite(ref32), torch.isfinite(ref16)
    err32 = float((got32 - ref32)[fin32].abs().max())
    err64 = float((got32.double() - truth)[fin32].abs().max())
    err16 = torch.where(fin16, (got16 - ref16).abs(), torch.zeros((), device=x.device))
    tol16 = 2 * bf16_ulp(ref16.nan_to_num().abs() + bias.bfloat16().float().abs())
    log(f"stem {name} {tuple(x.shape)} strides {x.stride()}: max abs err float32 {err32:.3g} (against the "
        f"float64 truth {err64:.3g}), bfloat16 {float(err16.max()):.3g} ({int((err16 > 0).sum())} of "
        f"{err16.numel()} outputs differ; {int((~fin16).sum())} not finite in the plain version)")
    if (got32.shape != shape or got16.shape != shape
            or not torch.allclose(got32[fin32], ref32[fin32], rtol=1e-5, atol=1e-4)
            or not torch.allclose(got32[fin32].double(), truth[fin32], rtol=1e-5, atol=1e-4)):
        raise AssertionError(f"stem float32 {name}: shape {tuple(got32.shape)}, max abs err {err32} "
                             f"(float64 truth {err64})")
    del truth
    if not bool((err16 <= tol16).all()):
        raise AssertionError(f"stem bfloat16 {name}: {int((err16 > tol16).sum())} outputs beyond two bf16 ulps")
    return float(err16.max()), out16, got32, ref32


def stem_kernel_rows(device, gen):
    """The fused stem at the eval canvases of 8 images, landscape and
    portrait, in float32 and bfloat16, against its plain version, read in
    place from an NCHW batch (the layout the model hands it) and from a
    contiguous NHWC copy (bitwise the same); at odd sizes and B = 1; with
    non-finite pixels. Timed: the kernel (`ms`, bf16; float32 logged),
    the ResNet "pallas" stem as the model calls it, from NCHW under bf16
    autocast (`ms_call`), and the port's conv-mode stem (cuDNN conv,
    FrozenBN, ReLU, max-pool under bf16 autocast) on the same weights as the
    yardstick, held against the float32 result like the kernel's bf16
    output. Logs the tensor-core instructions in the bf16 kernel's SASS and
    fails without them."""
    import torch

    from ubteacher_tpu_torch.modeling.resnet import ResNet
    from ubteacher_tpu_torch.ops.kernels import stem_cuda
    from ubteacher_tpu_torch.ops.stem import stem_conv_pool_plain

    sass = stem_sass_mma()
    log(f"stem bf16 kernel SASS: {sass['HMMA']} HMMA, {sass['HGMMA']} HGMMA instructions")
    if not sass["HMMA"] + sass["HGMMA"]:
        raise AssertionError("the stem's bf16 kernel has no tensor-core instructions")
    torch.backends.cudnn.allow_tf32 = False  # the plain float32 conv in full float32
    kernel = torch.randn((7, 7, 3, 64), generator=gen, device=device) * 0.1
    scale = torch.rand((64,), generator=gen, device=device) * 1.5 + 0.5
    bias = torch.randn((64,), generator=gen, device=device)
    nets = {}
    for mode in ("conv", "pallas"):
        nets[mode] = ResNet(depth=18, out_features=("res2",), stem_mode=mode).to(device)
        with torch.no_grad():
            nets[mode].stem_conv1.weight.copy_(kernel.permute(3, 2, 0, 1))
            nets[mode].stem_conv1_norm.scale.copy_(scale)
            nets[mode].stem_conv1_norm.bias.copy_(bias)

    def stem(mode, x_nchw):
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            return nets[mode].stem(x_nchw)

    err = 0.0
    for orient, (h, w) in (("landscape", EVAL_CANVAS), ("portrait", EVAL_CANVAS[::-1])):
        x_nchw = torch.randn((EVAL_BATCH, 3, h, w), generator=gen, device=device) * 50
        x = x_nchw.permute(0, 2, 3, 1)  # the model's view: no copy
        e16, out16, got32, ref32 = check_stem(orient, x, kernel, scale, bias)
        err = max(err, e16)
        conv16 = stem("conv", x_nchw).permute(0, 2, 3, 1).float()
        call16 = stem("pallas", x_nchw).permute(0, 2, 3, 1)
        nhwc = x.contiguous()
        torch.cuda.synchronize()
        if not (same_bytes(stem_cuda.stem_conv_pool_kernel(nhwc, kernel, scale, bias, torch.bfloat16), out16)
                and same_bytes(stem_cuda.stem_conv_pool_kernel(nhwc, kernel, scale, bias, torch.float32), got32)
                and same_bytes(call16.contiguous(), out16)):
            raise AssertionError(f"stem {orient}: the NHWC copy or the ResNet call differs from the NCHW view")
        log(f"stem {orient}: against the float32 result: kernel bf16 {float((out16.float() - ref32).abs().max()):.4g}, "
            f"conv-mode bf16 {float((conv16 - ref32).abs().max()):.4g} (|out| max {float(ref32.abs().max()):.4g}); "
            "NHWC copy and ResNet call bitwise equal to the NCHW view")
        if orient == "landscape":
            out_bytes = out16.numel() * 2
            ho, wo = -(-h // 2), -(-w // 2)
            row = {
                "name": "stem", "route": "cuda", "source": "ubteacher_tpu_torch/csrc/stem.cu",
                "replaces": "ubteacher_tpu/ops/pallas/stem_pallas.py:255",
                "ms": median_ms(lambda: stem_cuda.stem_conv_pool_kernel(x, kernel, scale, bias, torch.bfloat16)),
                "ms_call": median_ms(lambda: stem("pallas", x_nchw)),
                "plain_ms": median_ms(lambda: stem_conv_pool_plain(x, kernel, scale, bias, torch.bfloat16)),
                "ms_f32": median_ms(lambda: stem_cuda.stem_conv_pool_kernel(x, kernel, scale, bias, torch.float32)),
                # the image in and the pooled bf16 output; the conv's bf16
                # multiply-adds on the tensor cores
                **bound(nbytes(x) + out_bytes, 2.0 * EVAL_BATCH * ho * wo * 64 * 147, PEAK_BF16_TENSOR),
                # four calls (conv, FrozenBN, ReLU, max-pool): no one call computes the stem
                "library_ms": median_ms(lambda: stem("conv", x_nchw)),
            }
            log(f"stem: kernel {row['ms']:.4f} ms, as ResNet calls it {row['ms_call']:.4f} ms "
                f"({1e3 * (row['ms_call'] - row['ms']):.1f} us more)")
        del x_nchw, x, nhwc, out16, got32, ref32, conv16, call16
    # odd sizes at B = 1, NCHW views
    for h, w in ((799, 1343), (5, 3)):
        x = (torch.randn((1, 3, h, w), generator=gen, device=device) * 50).permute(0, 2, 3, 1)
        err = max(err, check_stem(f"odd {h}x{w}", x, kernel, scale, bias)[0])
    # non-finite pixels: each poisons only the windows that hold it; the pad
    # taps beside a window must read zeros, not its neighbour
    x = torch.randn((2, 64, 128, 3), generator=gen, device=device) * 50
    x[0, 10, 20, 1] = float("nan")
    x[0, 20, 30, :] = float("nan")  # column 4 q + 6: the pad taps of conv column 2 q + 1 would read it
    x[0, 40, 77, 0] = float("inf")
    x[1, 33, 3:6, 2] = float("-inf")
    x[1, 50, 100:128:3, :] = float("nan")
    err = max(err, check_stem("non-finite pixels", x, kernel, scale, bias)[0])
    row["max_abs_err"] = err
    torch.cuda.empty_cache()
    return [row]


def kernel_phase(device):
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    results = fcos_kernel_rows(device, gen) + rcnn_kernel_rows(device, gen) + stem_kernel_rows(device, gen)
    for r in results:
        extra = f" (float32 {r['ms_f32']:.4f} ms)" if "ms_f32" in r else ""
        extra += f" (device {r['device_ms']:.4f} ms)" if "device_ms" in r else ""
        extra += f" (RPN shape {r['ms_rpn']:.4f} ms)" if "ms_rpn" in r else ""
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        log(f"kernel {r['name']}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms{extra}{lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err {r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------
# setup shared by the reference and slice phases
# --------------------------------------------------------------------------


def to_device(value, device):
    """A tensor or a dataclass of tensors (PaddedInstances, StrongAugParams,
    SamplingDraws) on `device`."""
    if dataclasses.is_dataclass(value):
        return type(value)(**{f.name: getattr(value, f.name).to(device)
                              for f in dataclasses.fields(value)})
    return value.to(device)


def run_slice(name, state, steps, batch, burn_up, device):
    """1 + MUTUAL_STEPS steps with the launch counts reset just before and
    read just after, then one more mutual step under FlopCounterMode for
    the mutual steps' MFU. Returns (per-step (is_mutual, metrics), counts)."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    burnin, mutual = steps
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    history = []
    SLICE_STEP_MS[name] = []
    for i in range(1 + MUTUAL_STEPS):
        t0 = time.perf_counter()
        step = burnin if state.step < burn_up else mutual
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in metrics.items()}
        history.append((step is mutual, m))
        if step is mutual:
            SLICE_STEP_MS[name].append(ms)
        log(f"{name} step {i} ({'mutual' if step is mutual else 'burn-in'}) {ms:.1f} ms: "
            + ", ".join(f"{k}={v:.6g}" for k, v in m.items()))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"{name} launches {counts}; max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    for _, m in history:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{name}: non-finite metrics {bad}")
    flops, _, by_op = mfu.count_step_flops(mutual, state, batch)
    log_mfu(name, flops, by_op)
    return history, counts


def log_mfu(name, flops, by_op) -> None:
    """Each timed mutual step's MFU: FLOPs per step / step seconds / the
    card's dense-bf16 peak (by its name: SXM or PCIe)."""
    import torch

    part, peak = common.peak_bf16(torch.cuda.get_device_name(0))
    log(f"{name} FLOPs per mutual step {flops} ({flops / 1e12:.3f} TFLOP; FlopCounterMode: convolutions and "
        f"matmuls, 2 x MAC, forward and backward; the hand-written kernels 0; "
        f"{ {k: round(v / 1e12, 3) for k, v in by_op.items()} } TFLOP), peak {peak / 1e12:.0f} TFLOP/s dense bf16 "
        f"({part}), card {gpu_name_and_power()}")
    for i, ms in enumerate(SLICE_STEP_MS[name]):
        log(f"{name} mutual step {i}: {ms:.1f} ms, {flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, "
            f"mfu {100 * flops / (ms / 1e3) / peak:.2f}%")
    if flops <= 0:
        raise AssertionError(f"{name}: FlopCounterMode counted no work in the mutual step")


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


def reference_phase(device, extra_opts=()) -> None:
    import torch

    from ubteacher_tpu_torch.data.augment import draw_strong_params
    from ubteacher_tpu_torch.engine import make_fcos_train_steps

    # the CPU parity tests' configuration; the card runs it in float32
    cfg = load_cfg(FCOS_SMALL_OPTS + list(extra_opts))
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
    log(f"reference phase {list(extra_opts)} (cpu plain vs cuda kernels):",
        {k: (round(ref[k], 6), round(got[k], 6)) for k in ref})
    agree("reference phase", got, ref, ("num_pseudo_cls", "num_pseudo_reg", "num_nms_candidates"))
    if ref["num_pseudo_cls"] <= 0:
        raise AssertionError("reference phase: the teacher produced no pseudo boxes")


# --------------------------------------------------------------------------
# FCOS slice phase
# --------------------------------------------------------------------------


def slice_phase(device):
    cfg, steps, state, batch = common.step_setup(False, device)
    n_params = sum(p.numel() for p in state.student.parameters())
    log(f"slice: R-{cfg.MODEL.RESNETS.DEPTH} FCOS, {cfg.MODEL.FCOS.NUM_CLASSES} classes, "
        f"{n_params} parameters, canvas {CANVAS}, {BATCH_LABEL}+{BATCH_UNLABEL} images, "
        f"compute {cfg.TPU.COMPUTE_DTYPE}")

    history, counts = run_slice("fcos", state, steps, batch, cfg.SEMISUPNET.BURN_UP_STEP, device)
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
    cfg, steps, state, batch = common.step_setup(True, device)
    n_params = sum(p.numel() for p in state.student.parameters())
    log(f"rcnn slice: R-{cfg.MODEL.RESNETS.DEPTH}-FPN Faster R-CNN, {cfg.MODEL.ROI_HEADS.NUM_CLASSES} "
        f"classes, {cfg.MODEL.ROI_HEADS.LOSS}, {n_params} parameters, canvas {CANVAS}, "
        f"{BATCH_LABEL}+{BATCH_UNLABEL} images, compute {cfg.TPU.COMPUTE_DTYPE}")

    history, counts = run_slice("rcnn", state, steps, batch, cfg.SEMISUPNET.BURN_UP_STEP, device)
    mutual_metrics = [m for is_mutual, m in history if is_mutual]
    check_ema("rcnn", cfg, mutual_metrics)
    if not any(m["num_pseudo"] > 0 for m in mutual_metrics):
        raise AssertionError("rcnn: no mutual step had pseudo boxes")
    expect_counts("rcnn", counts, RCNN_EXPECTED)
    return counts


# --------------------------------------------------------------------------
# evaluation: the reference phase and the FCOS and Faster R-CNN eval slices
# --------------------------------------------------------------------------


def eval_dataset(images, num_classes, seed, max_boxes=12):
    """COCO-style dataset dicts for `images` ((count, (h, w)), ...): up to
    `max_boxes` gt boxes (xyxy, sides log-uniform from 8 px to 0.9 of the
    short edge, so all three COCO area ranges occur), the first box of every
    tenth image a crowd; and an in-memory image reader of seeded uint8 BGR
    noise, as TestDataLoader's image_loader."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dicts = []
    for h, w in (hw for n, hw in images for _ in range(n)):
        i = len(dicts)
        n = int(rng.integers(1, max_boxes + 1))
        bw, bh = np.exp(rng.uniform(np.log(8), np.log(0.9 * min(h, w)), (2, n)))
        x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        anns = [{"bbox": [float(x0[j]), float(y0[j]), float(x0[j] + bw[j]), float(y0[j] + bh[j])],
                 "category_id": int(rng.integers(0, num_classes)), "iscrowd": int(i % 10 == 0 and j == 0),
                 "area": float(bw[j] * bh[j])} for j in range(n)]
        dicts.append({"file_name": f"synthetic/{i}.png", "image_id": i + 1, "height": h, "width": w,
                      "annotations": anns})

    def image_loader(file_name):
        d = dicts[int(file_name.split("/")[1].split(".")[0])]
        return np.random.default_rng((seed, d["image_id"])).integers(0, 256, (d["height"], d["width"], 3), np.uint8)

    return dicts, image_loader


def gt_rows(dicts):
    """The non-crowd ground truth as collect_detections rows, score 1."""
    import numpy as np

    return np.asarray([[d["image_id"], o["bbox"][0], o["bbox"][1], o["bbox"][2] - o["bbox"][0],
                        o["bbox"][3] - o["bbox"][1], 1.0, o["category_id"]]
                       for d in dicts for o in d["annotations"] if not o["iscrowd"]], np.float64)


def eval_reference_phase(device) -> None:
    """The fused stem inside a small FCOS mutual step (its autograd.Function
    under the train step), then evaluation of the small FCOS configuration
    through TestDataLoader, on the card through the kernels and on the CPU
    through the plain versions, from the same weights and images."""
    import numpy as np
    import torch

    from ubteacher_tpu_torch.data.loader import TestDataLoader
    from ubteacher_tpu_torch.evaluation.evaluator import (
        collect_detections,
        inference_on_dataset,
        make_fcos_inference_fn,
    )

    reference_phase(device, ["TPU.STEM_MODE", "pallas"])

    cfg = load_cfg(FCOS_SMALL_OPTS + ["TPU.STEM_MODE", "pallas", "TPU.TEST_CANVAS", "(64, 96)",
                                      "INPUT.MIN_SIZE_TEST", "56", "INPUT.MAX_SIZE_TEST", "90", "TPU.EVAL_BATCH", "2"])
    dicts, image_loader = eval_dataset(((3, (48, 72)), (2, (80, 50))), cfg.MODEL.FCOS.NUM_CLASSES, seed=5)
    by_id = {d["image_id"]: d for d in dicts}
    runs = []
    for dev in (torch.device("cpu"), device):
        model = build_fcos_model(cfg, dev, seed=0, cls_bias=0.5)

        def loader():
            return TestDataLoader(cfg, dicts, batch_size=cfg.TPU.EVAL_BATCH, image_loader=image_loader)

        rows = collect_detections(model, loader(), by_id, make_fcos_inference_fn(cfg))[0]
        runs.append((rows, inference_on_dataset(cfg, model, loader(), dicts)))
    (ref_rows, ref), (got_rows, got) = runs
    log(f"eval reference phase: {len(ref_rows)} detections on the cpu, {len(got_rows)} on the card; AP cpu "
        f"{ref['AP']:.6f} card {got['AP']:.6f}")
    # the kept set and classes equal; boxes within 5e-3 px and scores within
    # 1e-4 (the rcnn reference phase's bounds); AP fields within 1e-6
    if len(ref_rows) == 0 or ref_rows.shape != got_rows.shape or not np.array_equal(
            ref_rows[:, [0, 6]], got_rows[:, [0, 6]]):
        raise AssertionError("eval reference phase: the detections differ in their kept set or classes")
    for cols, tol, what in (([1, 2, 3, 4], 5e-3, "boxes"), ([5], 1e-4, "scores")):
        err = float(np.abs(got_rows[:, cols] - ref_rows[:, cols]).max())
        if err > tol:
            raise AssertionError(f"eval reference phase: {what} max abs err {err}")
    for k, v in ref.items():
        if k != "inference_sec_per_image" and not (abs(got[k] - v) <= 1e-6 or (math.isnan(v) and math.isnan(got[k]))):
            raise AssertionError(f"eval reference phase: {k} cuda {got[k]} vs cpu {v}")


def run_eval(name, cfg, model, dicts, image_loader, num_classes, infer_fn, proposal_fn, device):
    """The evaluation entry points as a trainer's test() drives them, with
    the launch counts reset just before and read just after."""
    import torch

    from ubteacher_tpu_torch.data.loader import TestDataLoader
    from ubteacher_tpu_torch.evaluation.evaluator import inference_on_dataset
    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    loader = TestDataLoader(cfg, dicts, batch_size=cfg.TPU.EVAL_BATCH, image_loader=image_loader)
    if len(loader) != EVAL_BATCHES:
        raise AssertionError(f"{name}: {len(loader)} batches, expected {EVAL_BATCHES}")
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = inference_on_dataset(cfg, model, loader, dicts, nms_method=cfg.MODEL.FCOS.NMS_CRITERIA_TEST,
                                    num_classes=num_classes, infer_fn=infer_fn, proposal_fn=proposal_fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"{name}: {len(dicts)} images in {seconds:.2f} s, inference_sec_per_image "
        f"{results.get('inference_sec_per_image', float('nan')):.6f}; launches {counts}; max_memory_allocated "
        f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"{name} metrics: " + ", ".join(f"{k}={v:.6g}" for k, v in results.items()))
    bad = [k for k in EVAL_SUMMARY if not math.isfinite(results[k])]
    if bad or not results.get("inference_sec_per_image", 0) > 0:
        raise AssertionError(f"{name}: non-finite summary metrics {bad} or no timed batch")
    return results, counts


def expect_counts(name, counts, expected) -> None:
    full = dict.fromkeys(counts, 0)
    full.update(expected)
    if counts != full:
        raise AssertionError(f"{name} launches {counts}, expected {full}")


def fcos_eval_slice_phase(device):
    """fcos_R_50_ut2_sup1_run0.yaml with the fused stem, full width, random
    weights: TestDataLoader + inference_on_dataset as the trainer's test()
    drives them. Per batch: one stem and one NMS launch (fcos_decode)."""
    import torch

    from ubteacher_tpu_torch.evaluation.evaluator import evaluate_detection_rows, make_fcos_inference_fn

    cfg = load_cfg(["TPU.STEM_MODE", "pallas"])
    model = build_fcos_model(cfg, device, seed=0, cls_bias=SLICE_CLS_BIAS)
    num_classes = cfg.MODEL.FCOS.NUM_CLASSES
    dicts, image_loader = eval_dataset(EVAL_IMAGES, num_classes, seed=1)
    log(f"fcos eval slice: R-{cfg.MODEL.RESNETS.DEPTH} FCOS, {num_classes} classes, stem "
        f"{cfg.TPU.STEM_MODE}, test canvas {tuple(cfg.TPU.TEST_CANVAS)}, batch {cfg.TPU.EVAL_BATCH}, "
        f"compute {cfg.TPU.COMPUTE_DTYPE}")
    # the default inference function (NMS_CRITERIA_TEST), counting what it keeps
    infer = make_fcos_inference_fn(cfg, cfg.MODEL.FCOS.NMS_CRITERIA_TEST)
    kept = []

    def counted(m, images, hw):
        dets = infer(m, images, hw)
        kept.append(dets.mask.sum())
        return dets

    _, counts = run_eval("fcos eval slice", cfg, model, dicts, image_loader, num_classes, counted, None, device)
    n_kept = int(torch.stack(kept).sum())
    log(f"fcos eval slice: {n_kept} detections kept")
    if n_kept == 0:
        raise AssertionError("fcos eval slice: no detections")
    expect_counts("fcos eval slice", counts, {"stem": EVAL_BATCHES, "nms": EVAL_BATCHES})
    oracle = evaluate_detection_rows(gt_rows(dicts), dicts, num_classes)
    log("ground truth as detections: " + ", ".join(f"{k}={oracle[k]:.6g}" for k in EVAL_SUMMARY))
    if any(abs(oracle[k] - 100.0) > 1e-9 for k in ("AP", "AP50", "AP75")):
        raise AssertionError("the ground truth fed back as detections does not score AP 100")
    return counts


def rcnn_eval_slice_phase(device):
    """faster_rcnn_R_50_FPN_ut2_sup1_run0.yaml with the fused stem and
    TEST.EVAL_PROPOSALS, full width, random weights. Per batch: the
    inference function runs the stem, the RPN's NMS, the box head's ROIAlign
    and fast_rcnn_inference's NMS; the proposal function the stem and the
    RPN's NMS again."""
    from ubteacher_tpu_torch.engine.rcnn_trainer import make_rcnn_inference_fn, make_rcnn_proposal_fn

    cfg = load_cfg(["TPU.STEM_MODE", "pallas", "TEST.EVAL_PROPOSALS", "True"], RCNN_CFG)
    model = build_rcnn_model(cfg, device, seed=0, cls_bias=RCNN_SLICE_CLS_BIAS)
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    dicts, image_loader = eval_dataset(EVAL_IMAGES, num_classes, seed=1)
    log(f"rcnn eval slice: R-{cfg.MODEL.RESNETS.DEPTH}-FPN Faster R-CNN, {num_classes} classes, stem "
        f"{cfg.TPU.STEM_MODE}, proposals evaluated {cfg.TEST.EVAL_PROPOSALS}")
    results, counts = run_eval(
        "rcnn eval slice", cfg, model, dicts, image_loader, num_classes, make_rcnn_inference_fn(cfg),
        make_rcnn_proposal_fn(cfg) if cfg.TEST.EVAL_PROPOSALS else None, device,
    )
    expect_counts("rcnn eval slice", counts,
                  {"stem": 2 * EVAL_BATCHES, "nms": 3 * EVAL_BATCHES, "roi_align_fwd": EVAL_BATCHES})
    ar = [f"AR{s}@{n}" for n in (100, 1000) for s in ("", "s", "m", "l")]
    bad = [k for k in ar if not math.isfinite(results.get(k, float("nan")))]
    if bad:
        raise AssertionError(f"rcnn eval slice: proposal recall fields missing or not finite: {bad}")
    return counts


# --------------------------------------------------------------------------
# the train loops: UBTeacherTrainer / UBRCNNTeacherTrainer.train() on the card
# --------------------------------------------------------------------------


def time_loader(loader) -> float:
    """The loader alone: host ms per batch over LOADER_BATCHES batches after
    one untimed batch (its prefetch thread and pool at TPU.DATA_THREADS)."""
    it = iter(loader)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        return (time.perf_counter() - t0) * 1e3 / LOADER_BATCHES
    finally:
        it.close()
        loader.close()


def read_lines(output_dir):
    with open(os.path.join(output_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def same_state(a, b) -> list:
    """Names of the tensors (both models, the momentum buffers) and scalars
    (step, update count, generator state) that differ between two
    checkpoint_state() dicts."""
    import torch

    bad = [f"{part}.{k}" for part in ("student", "teacher")
           for k, v in a[part].items() if not torch.equal(v, b[part][k])]
    sa, sb = a["optimizer"]["sgd"]["state"], b["optimizer"]["sgd"]["state"]
    if set(sa) != set(sb) or not sa:
        bad.append("optimizer state keys")
    bad += [f"momentum {k}" for k in sa if k in sb
            and not torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"])]
    bad += [k for k in ("step",) if a[k] != b[k]]
    if a["optimizer"]["count"] != b["optimizer"]["count"]:
        bad.append("optimizer count")
    if not torch.equal(a["generator"], b["generator"]):
        bad.append("generator")
    return bad


def loop_opts(out_dir, iters, burn_up, ckpt_period, eval_period) -> list:
    """The train loops' overrides of a recipe: 8 + 8 images (the global
    batch), 8 data threads, random weights."""
    return ["SOLVER.IMG_PER_BATCH_LABEL", str(BATCH_LABEL), "SOLVER.IMG_PER_BATCH_UNLABEL", str(BATCH_UNLABEL),
            "SOLVER.MAX_ITER", str(iters), "SEMISUPNET.BURN_UP_STEP", str(burn_up), "SOLVER.CHECKPOINT_PERIOD",
            str(ckpt_period), "TEST.EVAL_PERIOD", str(eval_period), "TPU.DATA_THREADS", "8", "MODEL.WEIGHTS", "",
            "OUTPUT_DIR", out_dir]


def loop_datasets(num_classes):
    """The train loops' seeded in-memory images: (datasets, image_loader)."""
    dicts, image_loader = eval_dataset(LOOP_IMAGES, num_classes, seed=3)
    n_label, n_unlabel = (sum(n for n, _ in LOOP_IMAGES[k:k + 2]) for k in (0, 2))
    return {"train": dicts[:n_label], "train_unlabel": dicts[n_label:n_label + n_unlabel],
            "test": dicts[n_label + n_unlabel:], "meta": {}}, image_loader


def sync_sites(caught) -> dict:
    """{file:line: count} of torch's sync-debug warnings under the repo."""
    return dict(collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
                                    if "synchroniz" in str(w.message)))


def check_only_metrics_fetch(name, sites, iterations) -> None:
    """The port's only wait for the device is the metrics fetch, once an
    iteration; the checkpoint's copies (and a barrier's wait) sit in
    torch's own files."""
    port_sites = {k: v for k, v in sites.items() if k.startswith("ubteacher_tpu_torch/")}
    if len(port_sites) != 1 or not all(k.startswith("ubteacher_tpu_torch/engine/trainer.py") and v == iterations
                                       for k, v in port_sites.items()):
        raise AssertionError(f"{name}: the port waits for the device at {port_sites}, "
                             f"expected the metrics fetch once an iteration")


def train_loop_phase(device, name, trainer_cls, cfg_path, set_bias, kernels):
    """The training run through the trainer's entry points at the recipe's
    full width, then a resumed run of RESUME_STEPS more iterations; returns
    the kernels' launch counts over both runs (each reset just before its
    train() and read just after)."""
    import shutil

    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    max_iter, burn_up, ckpt_period, eval_period = LOOP_RUNS[name]
    out_dir = os.path.join(ROOT, "ubteacher_tpu_torch", "_build", "chip_smoke_runs", name)
    shutil.rmtree(out_dir, ignore_errors=True)

    def cfg_for(iters):
        return load_cfg(loop_opts(out_dir, iters, burn_up, ckpt_period, eval_period), cfg_path)

    cfg = cfg_for(max_iter)
    num_classes = cfg.MODEL.FCOS.NUM_CLASSES if name == "fcos" else cfg.MODEL.ROI_HEADS.NUM_CLASSES
    datasets, image_loader = loop_datasets(num_classes)

    def trainer(c):
        t = trainer_cls(c, datasets=datasets, image_loader=image_loader, device=device)
        t.storage.log_period = 1
        return t

    t1 = trainer(cfg)
    log(f"{name} train loop: R-{cfg.MODEL.RESNETS.DEPTH}, {num_classes} classes, canvases "
        f"{tuple(cfg.TPU.CANVAS_LANDSCAPE)} / {tuple(cfg.TPU.CANVAS_PORTRAIT)} + {list(cfg.TPU.EXTRA_TRAIN_CANVASES)}, "
        f"MIN_SIZE_TRAIN {tuple(cfg.INPUT.MIN_SIZE_TRAIN)} {cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING}, "
        f"{cfg.SOLVER.IMG_PER_BATCH_LABEL}+{cfg.SOLVER.IMG_PER_BATCH_UNLABEL} images, {max_iter} iterations "
        f"(burn-in {burn_up}), {cfg.TPU.DATA_THREADS} data threads")
    loader_ms = time_loader(t1.loader)
    log(f"{name} train loop: the loader alone, {loader_ms:.1f} host ms per batch at {cfg.TPU.DATA_THREADS} threads")
    set_bias(t1.state.student)
    t1.resume_or_load(resume=False)

    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    t1.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    lines = read_lines(out_dir)
    steps = [m for m in lines if "total_loss" in m]
    for m in steps:
        log(f"{name} train loop iteration {m['iteration']}: time {m['time'] * 1e3:.1f} ms, data_time "
            f"{m['data_time'] * 1e3:.1f} ms, total_loss {m['total_loss']:.6g}, "
            + ", ".join(f"{k}={v:.6g}" for k, v in m.items() if k.startswith("num_")))
    mutual_ms = [m["time"] * 1e3 for m in steps[burn_up:]]
    LOOP_ITER_MS[name] = [m["time"] * 1e3 for m in steps]
    log(f"{name} train loop: {len(steps)} iterations + checkpoints + eval in {seconds:.1f} s; launches {counts}; "
        f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB); median mutual iteration {statistics.median(mutual_ms):.1f} "
        f"ms (slice phase's median mutual step {statistics.median(SLICE_STEP_MS[name]):.1f} ms); median data_time "
        f"{statistics.median(m['data_time'] for m in steps) * 1e3:.1f} ms")

    if len(steps) != max_iter:
        raise AssertionError(f"{name} train loop: {len(steps)} metrics lines, expected {max_iter}")
    bad = [(m["iteration"], k) for m in steps for k, v in m.items()
           if (k.startswith("loss") or k == "total_loss") and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{name} train loop: non-finite losses {bad}")
    check_ema(f"{name} train loop", cfg, steps[burn_up:])
    evals = {k: v for m in lines for k, v in m.items() if k.endswith("/AP")}
    log(f"{name} train loop eval: " + ", ".join(f"{k}={v:.6g}" for k, v in evals.items()))
    if set(evals) != {"teacher/AP", "student/AP"} or not all(math.isfinite(v) for v in evals.values()):
        raise AssertionError(f"{name} train loop: the eval gave {evals}")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name} train loop: kernels not launched: {missing}")
    if t1.checkpointer.latest_step() != max_iter:
        raise AssertionError(f"{name} train loop: checkpoints {t1.checkpointer.steps()}")

    # resume: the saved state bitwise, then RESUME_STEPS more iterations
    t2 = trainer(cfg_for(max_iter + RESUME_STEPS))
    t2.resume_or_load(resume=True)
    bad = same_state(t2.checkpoint_state(), t1.checkpoint_state())
    if t2.start_iter != max_iter or bad:
        raise AssertionError(f"{name} train loop: resume at {t2.start_iter}, differing {bad[:8]}")
    log(f"{name} train loop: resumed at iteration {t2.start_iter}, every parameter, momentum buffer, the step, "
        "the update count and the generator state bitwise equal to the saved run's")
    del t1
    torch.cuda.synchronize()
    reset_launch_counts()
    # where the resumed run waits for the device: torch's sync debug mode
    # warns at every synchronizing call, counted here by its Python site
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t2.train()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = sync_sites(caught)
    log(f"{name} train loop: synchronizing calls by site over the resumed run ({RESUME_STEPS} iterations, "
        f"one checkpoint): {sites}")
    check_only_metrics_fetch(f"{name} train loop", sites, RESUME_STEPS)
    for k, v in launch_counts().items():
        counts[k] += v
    more = [m for m in read_lines(out_dir)[len(lines):] if "total_loss" in m]
    if t2.state.step != max_iter + RESUME_STEPS or len(more) != RESUME_STEPS:
        raise AssertionError(f"{name} train loop: the resumed run took {len(more)} steps to {t2.state.step}")
    bad = [k for m in more for k, v in m.items() if k.startswith("loss") and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{name} train loop: the resumed run's losses {bad} are not finite")
    LOOP_RESUMED_MS[name] = [m["time"] * 1e3 for m in more]
    log(f"{name} train loop: the resumed run took iterations {max_iter + 1}..{max_iter + RESUME_STEPS}, times "
        + ", ".join(f"{m['time'] * 1e3:.1f}" for m in more) + " ms")
    del t2
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


def fcos_loop_phase(device):
    import torch

    def bias(model):
        with torch.no_grad():
            model.head.cls_logits.bias.fill_(SLICE_CLS_BIAS)

    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

    return train_loop_phase(device, "fcos", UBTeacherTrainer, CFG, bias, FCOS_KERNELS)


def rcnn_loop_phase(device):
    import torch

    def bias(model):
        with torch.no_grad():
            model.box_predictor.cls_score.bias[0] = RCNN_SLICE_CLS_BIAS

    from ubteacher_tpu_torch.engine.trainer import UBRCNNTeacherTrainer

    return train_loop_phase(device, "rcnn", UBRCNNTeacherTrainer, RCNN_CFG, bias, tuple(RCNN_EXPECTED))


# --------------------------------------------------------------------------
# the FCOS lift: tools/learning_sanity.py's ablation at tests/test_fcos_lift.py's recipe
# --------------------------------------------------------------------------

# tests/test_fcos_lift.py's recipe: 1000 steps, burn-in 600, 128x128, 64
# images of which 8 labeled, colour jitter 40, seed 0
LIFT_RECIPE = dict(steps=1000, burnin=600, size=128, images=64, label_images=8, jitter=40, seed=0)


def lift_phase(device, rcnn=False):
    """The supervised-only vs SSOD ablation through the trainers' entry
    points on the card, its launch counts reset just before and read just
    after. FCOS must lift as tests/test_fcos_lift.py asserts (the SSOD
    student and teacher above the supervised student, mean pseudo boxes a
    batch above 1); the R-CNN ablation has no pass mark (the JAX package
    pins none): finite AP fields and recorded pseudo counts."""
    import argparse
    import contextlib
    import io

    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    name = "rcnn lift" if rcnn else "fcos lift"
    args = argparse.Namespace(rcnn=rcnn, bbox_thresh=None, oracle_pseudo=False, cpu=False, opts=[], **LIFT_RECIPE)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    printed = io.StringIO()  # the tool's JSON line, logged below under the phase's name
    with contextlib.redirect_stdout(printed):
        out = learning_sanity.run_ablation(args)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{name}: {json.dumps(out)}")
    log(f"{name}: both arms in {time.perf_counter() - t0:.1f} s; launches {counts}")
    aps = [out["sup"]["ap_student"], out["ssod"]["ap_student"], out["ssod"].get("ap_teacher", float("nan"))]
    if not all(math.isfinite(v) for v in aps) or out["ssod"]["mean_pseudo_boxes"] is None:
        raise AssertionError(f"{name}: AP fields {aps}, mean pseudo boxes {out['ssod']['mean_pseudo_boxes']}")
    if not rcnn and not (out["ssod_beats_sup_student"] and out["ssod_beats_sup_teacher"]
                         and out["ssod"]["mean_pseudo_boxes"] > 1.0):
        raise AssertionError(f"{name}: no SSOD lift at the seeded recipe: {out}")
    expected = ("nms", "matcher", "roi_align_fwd", "roi_align_bwd", "row_scatter") if rcnn else FCOS_KERNELS
    missing = [k for k in expected if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    return counts


def run_lifts(device) -> None:
    """--lift: the FCOS lift (asserted) and the R-CNN ablation (recorded)."""
    lift_phase(device)
    lift_phase(device, rcnn=True)


# --------------------------------------------------------------------------
# data parallel: ranks of ubteacher_tpu_torch.parallel on the one card
# --------------------------------------------------------------------------

DP_WORLD = 2
DP_DIR = os.path.join(ROOT, "ubteacher_tpu_torch", "_build", "chip_smoke_dp")
# (a): 4 + 4 FCOS images (2 + 2 a rank; the labeled rows of rank 1 hold one
# gt box, rank 0's four, so the ranks' positive counts differ) and the
# R-CNN reference phase's 2 + 2
DP_SMALL_B = 4
# (b), (c): (iterations, burn-in) of the full-width FCOS runs; (b) checkpoints
# at its last iteration and then evaluates the 16 test images of phase 10;
# (c) runs its iterations, then RESUME_STEPS more resumed (timed and checked,
# as phase 10's resumed run: the loader restarts from its seed, so both
# resumed runs take the same batches)
DP_LOOP = (4, 1)
DP_NCCL_LOOP = (2, 1)
# seconds a collective waits for a silent peer before the run fails
DP_TIMEOUT = 300.0


def dp_small_cases():
    """(a)'s cases, built alike in every process: {name: (cfg, make_steps,
    build_state, global batch on the CPU, [(step fn name, step, extra
    batch keys)])}, the draws for the global batch injected."""
    import torch

    from ubteacher_tpu_torch.data.augment import draw_strong_params
    from ubteacher_tpu_torch.engine import make_fcos_train_steps
    from ubteacher_tpu_torch.engine.rcnn_trainer import make_rcnn_train_steps

    cfg = load_cfg(FCOS_SMALL_OPTS + ["SEMISUPNET.BURN_UP_STEP", "1"])
    canvas = (64, 96)
    cpu = torch.device("cpu")
    batch = synthetic_batch(cfg, DP_SMALL_B, DP_SMALL_B, canvas, torch.Generator().manual_seed(100), cpu)
    batch["gt_label"].mask[DP_SMALL_B // 2:, 1:] = False
    draws = torch.Generator().manual_seed(7)
    fcos_steps = [("burnin", 0, {"strong_label": draw_strong_params(DP_SMALL_B, *canvas, draws)}),
                  ("mutual", 1, {"strong_label": draw_strong_params(DP_SMALL_B, *canvas, draws),
                                 "strong_unlabel": draw_strong_params(DP_SMALL_B, *canvas, draws)})]
    rcfg = load_cfg(RCNN_SMALL_OPTS, RCNN_CFG)
    rbatch = rcnn_small_batch(rcfg)
    sup = rbatch.pop("sampling_sup")
    b = rbatch["images_label_k"].shape[0]
    views = 2 if rcfg.SEMISUPNET.USE_SUP_STRONG == "both" else 1
    n_props = rcfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + rcfg.TPU.MAX_GT  # the burn-in's gt slots
    burnin_draws = type(sup)(sup.rpn[:views * b], sup.roi[:views * b, :, :n_props].contiguous())
    rcnn_steps = [("burnin", 0, {"sampling_sup": burnin_draws}),
                  ("mutual", rcfg.SEMISUPNET.BURN_UP_STEP, {"sampling_sup": sup})]
    return {
        "fcos": (cfg, make_fcos_train_steps, lambda dev: build_state(cfg, dev, seed=0, cls_bias=0.5), batch,
                 fcos_steps),
        "rcnn": (rcfg, make_rcnn_train_steps, lambda dev: build_rcnn_state(rcfg, dev, seed=0, cls_bias=2.5),
                 rbatch, rcnn_steps),
    }


def local_rows(batch):
    """This rank's rows of a global batch's streams; draws stay global (the
    steps take their own rows of them)."""
    from ubteacher_tpu_torch.parallel import owned_rows

    streams = {"images_label_k": "images_label_k", "gt_label": "images_label_k", "label_hw": "images_label_k",
               "images_unlabel_k": "images_unlabel_k", "gt_unlabel": "images_unlabel_k",
               "unlabel_hw": "images_unlabel_k"}
    out = dict(batch)
    for k, ref in streams.items():
        if k in batch:
            own = owned_rows(batch[ref].shape[0])
            v = batch[k]
            out[k] = v.map(lambda x: x[own]) if dataclasses.is_dataclass(v) else v[own]
    return out


def bitwise_across_ranks(*modules) -> bool:
    """Every rank's parameters bit for bit rank 0's (a broadcast and a
    compare on each rank)."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for m in modules for p in m.parameters()])
    theirs = flat.clone()
    dist.broadcast(theirs, 0)
    return torch.equal(flat.view(torch.int32), theirs.view(torch.int32))


def run_dp_small(device, names=("fcos", "rcnn")):
    """(a)'s steps (of the cases `names`) on this process's rows -> {name:
    [(global metrics, the student's parameters on the CPU, bitwise equal
    across ranks)]}."""
    import torch

    from ubteacher_tpu_torch.engine.trainer import host_metrics
    from ubteacher_tpu_torch.parallel import is_distributed

    out = {}
    for name, (cfg, make, build, batch, steps) in dp_small_cases().items():
        if name not in names:
            continue
        fns = dict(zip(("burnin", "mutual"), make(cfg)))
        out[name] = []
        for which, step, extra in steps:
            state = build(device)
            state.step = step
            _, m = fns[which](state, {k: to_device(v, device) for k, v in local_rows(dict(batch, **extra)).items()})
            same = bitwise_across_ranks(state.student, state.teacher) if is_distributed() else True
            out[name].append((host_metrics(m), {k: v.cpu() for k, v in state.student.state_dict().items()}, same))
        torch.cuda.synchronize()
    return out


def dp_small_rank(out_dir):
    """(a) on one gloo rank of cuda:0."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.parallel import rank

    reset_launch_counts()
    res = run_dp_small(torch.device("cuda", 0))
    torch.save({"steps": res, "counts": launch_counts()}, os.path.join(out_dir, f"small_rank{rank()}.pt"))


def dp_loop_trainer(cfg, device):
    """Phase 10's FCOS trainer (its in-memory images, the slice's cls bias)
    of `cfg`, logging every iteration."""
    import torch

    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

    datasets, image_loader = loop_datasets(cfg.MODEL.FCOS.NUM_CLASSES)
    t = UBTeacherTrainer(cfg, datasets=datasets, image_loader=image_loader, device=device)
    t.storage.log_period = 1
    with torch.no_grad():
        t.state.student.head.cls_logits.bias.fill_(SLICE_CLS_BIAS)
    return t


def dp_trainer_rank(out_dir, opts):
    """(b) on one gloo rank of cuda:0: train, checkpoint (rank 0), evaluate
    the rank's share of the test set, gather the share's ground truth as
    detection rows and score them, then resume from the checkpoint."""
    import torch

    import numpy as np

    from ubteacher_tpu_torch.evaluation.evaluator import evaluate_detection_rows
    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.parallel import allgather_host_rows, rank, world_size

    device = torch.device("cuda", 0)
    cfg = load_cfg(opts, CFG)
    t1 = dp_loop_trainer(cfg, device)
    t1.resume_or_load(resume=False)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    t1.train()
    results = t1.test(model="teacher")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the gather with rows that score: each rank's share of the test set's
    # ground truth fed back as detections must score AP 100 on every rank
    test = t1.datasets["test"]
    share = np.array_split(np.arange(len(test)), world_size())[rank()]
    oracle = evaluate_detection_rows(allgather_host_rows(gt_rows([test[i] for i in share])), test,
                                     t1.cfg.MODEL.FCOS.NUM_CLASSES)
    counts = launch_counts()
    same = bitwise_across_ranks(t1.state.student, t1.state.teacher)
    saved = t1.checkpoint_state()
    peak = torch.cuda.max_memory_allocated(device)
    del t1
    t2 = dp_loop_trainer(cfg, device)
    t2.resume_or_load(resume=True)
    bad = same_state(t2.checkpoint_state(), saved)
    with open(os.path.join(out_dir, f"rank{rank()}.json"), "w") as f:
        json.dump({"eval": results, "oracle": {k: oracle[k] for k in ("AP", "AP50", "AP75")}, "counts": counts, "seconds": seconds, "bitwise": same, "peak": peak,
                   "resume_at": t2.start_iter, "resume_differs": bad[:8]}, f)


def dp_nccl_rank(out_dir, argv):
    """(c): one nccl rank through the CLI's pieces (its parser, setup and
    device rule; the trainer on in-memory images, cv2 being absent here):
    DP_NCCL_LOOP's iterations, then the --resume run of RESUME_STEPS more
    under torch's sync debug mode; then phase 4's FCOS slice steps (seeded
    weights and batch), timed as phase 4 times them."""
    import torch
    import torch.distributed as dist

    from ubteacher_tpu_torch import train_net
    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    args = train_net.default_argument_parser().parse_args(argv)
    cfg = train_net.setup(args)
    device = torch.device(train_net.device_of(cfg))
    first = cfg.clone()
    first.defrost()
    first.SOLVER.MAX_ITER = DP_NCCL_LOOP[0]
    first.freeze()
    t = dp_loop_trainer(first, device)
    t.resume_or_load(resume=False)
    t.train()
    del t
    t = dp_loop_trainer(cfg, device)
    t.resume_or_load(resume=args.resume)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t.train()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts, peak = launch_counts(), torch.cuda.max_memory_allocated(device)
    del t
    torch.cuda.empty_cache()
    _, (burnin, mutual), state, batch = common.step_setup(False, device)
    step_ms = []
    for _ in range(1 + MUTUAL_STEPS):
        t0 = time.perf_counter()
        state, _ = (burnin if state.step < 1 else mutual)(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    with open(os.path.join(out_dir, "nccl.json"), "w") as f:
        json.dump({"sites": sync_sites(caught), "counts": counts, "backend": dist.get_backend(),
                   "world": dist.get_world_size(), "device": str(device), "peak": peak, "step_ms": step_ms}, f)


def add_counts(total, counts) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def dp_small_part(device, counts) -> None:
    """(a): both steps of both trainers at the reference phases' sizes on two
    gloo ranks of cuda:0 against one process with the whole batch on the
    card. Counts (num_*) and ema_rate_1000x equal, losses within 1e-3
    relative + 1e-4 (agree(): cuDNN picks its algorithms by batch size),
    parameter updates within 1e-2 of one process's over the model, the
    ranks' parameters bitwise equal."""
    import torch

    from ubteacher_tpu_torch.parallel import launch

    ref = run_dp_small(device)
    t0 = time.perf_counter()
    launch(dp_small_rank, DP_WORLD, backend="gloo", args=(DP_DIR,), timeout=DP_TIMEOUT)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(DP_DIR, f"small_rank{r}.pt"), weights_only=False) for r in range(DP_WORLD)]
    check_dp_small("data parallel (a)", ref, [rk["steps"] for rk in ranks])
    for rk in ranks:
        add_counts(counts, rk["counts"])
    log(f"data parallel (a): {DP_WORLD} gloo ranks on one card in {seconds:.1f} s (spawn included); launches "
        f"{[rk['counts'] for rk in ranks]}")


def check_dp_small(label, ref, ranks) -> None:
    """Each rank's run_dp_small against one process's: counts and
    ema_rate equal and losses as agree() holds them, the parameter updates
    within 1e-2 of one process's over the model, the ranks bitwise equal."""
    import torch

    cases = dp_small_cases()
    for name, steps in ref.items():
        init = {k: v.cpu() for k, v in cases[name][2](torch.device("cpu")).student.state_dict().items()}
        for i, (m_ref, sd_ref, _) in enumerate(steps):
            for r, rk in enumerate(ranks):
                m, sd, same = rk[name][i]
                what = f"{label} {name} step {i} rank {r}"
                agree(what, m, m_ref, [k for k in m_ref if k.startswith("num_") or k == "ema_rate_1000x"])
                num = den = worst = 0.0
                for k, v in sd_ref.items():
                    d_ref = v.double() - init[k].double()
                    d_got = sd[k].double() - init[k].double()
                    num += float((d_got - d_ref).norm() ** 2)
                    den += float(d_ref.norm() ** 2)
                    if d_ref.any():
                        worst = max(worst, float((d_got - d_ref).norm() / d_ref.norm()))
                err = (num / max(den, 1e-300)) ** 0.5
                log(f"{what}: metrics agree; update error {err:.3g} over the model, worst tensor {worst:.3g}; "
                    f"parameters bitwise equal across ranks: {same}")
                if not (den > 0 and err < 1e-2 and same):
                    raise AssertionError(f"{what}: update error {err}, bitwise across ranks {same}")


def dp_trainer_part(device, counts) -> None:
    """(b): the full-width FCOS recipe through the trainer's entry points on
    two gloo ranks of cuda:0 (8 + 8 global, 4 + 4 a rank): burn-in, the
    boundary and two mutual steps, one checkpoint by rank 0, the teacher's
    eval of 16 images split over the ranks; then one process's eval of the
    checkpoint. Losses finite, parameters bitwise equal across ranks, the
    ranks' AP fields equal and within 0.01 AP of one process's, the gathered
    ground truth at AP 100 on every rank, the resumed state bitwise the
    saved one."""
    import shutil

    import torch

    from ubteacher_tpu_torch.parallel import launch

    max_iter, burn_up = DP_LOOP
    out_dir = os.path.join(DP_DIR, "trainer")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    opts = loop_opts(out_dir, max_iter, burn_up, max_iter, 0)
    t0 = time.perf_counter()
    launch(dp_trainer_rank, DP_WORLD, backend="gloo", args=(out_dir, opts), timeout=DP_TIMEOUT)
    seconds = time.perf_counter() - t0
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    steps = [m for m in read_lines(out_dir) if "total_loss" in m]
    for m in steps:
        log(f"data parallel (b) iteration {m['iteration']}: time {m['time'] * 1e3:.1f} ms, data_time "
            f"{m['data_time'] * 1e3:.1f} ms, total_loss {m['total_loss']:.6g}, "
            + ", ".join(f"{k}={v:.6g}" for k, v in m.items() if k.startswith("num_")))
    bad = [(m["iteration"], k) for m in steps for k, v in m.items()
           if (k.startswith("loss") or k == "total_loss") and not math.isfinite(v)]
    if len(steps) != max_iter or bad:
        raise AssertionError(f"data parallel (b): {len(steps)} iterations, non-finite losses {bad}")
    check_ema("data parallel (b)", load_cfg(opts, CFG), steps[burn_up:])
    for r, rk in enumerate(ranks):
        log(f"data parallel (b) rank {r}: train + eval {rk['seconds']:.1f} s, max_memory_allocated {rk['peak']} "
            f"bytes ({rk['peak'] / 2**30:.2f} GiB), launches {rk['counts']}")
        log(f"data parallel (b) rank {r}: the test set's ground truth gathered from both ranks' shares scores "
            f"{rk['oracle']}")
        if any(abs(v - 100.0) > 1e-9 for v in rk["oracle"].values()):
            raise AssertionError(f"data parallel (b) rank {r}: the gathered ground truth scores {rk['oracle']}")
        if not rk["bitwise"] or rk["resume_at"] != max_iter or rk["resume_differs"]:
            raise AssertionError(f"data parallel (b) rank {r}: bitwise across ranks {rk['bitwise']}, resumed at "
                                 f"{rk['resume_at']}, differing {rk['resume_differs']}")
        add_counts(counts, rk["counts"])
    missing = [k for k in FCOS_KERNELS if not all(rk["counts"][k] for rk in ranks)]
    if missing:
        raise AssertionError(f"data parallel (b): kernels not launched on every rank: {missing}")
    ckpts = sorted(n for n in os.listdir(os.path.join(out_dir, "checkpoints")) if n.isdigit())
    if ckpts != [str(max_iter)]:
        raise AssertionError(f"data parallel (b): checkpoints {ckpts}")

    one = dp_loop_trainer(load_cfg(opts, CFG), device)
    one.resume_or_load(resume=True)
    ref = one.test(model="teacher")
    del one
    torch.cuda.empty_cache()
    fields = [k for k in EVAL_SUMMARY if k in ref]
    log("data parallel (b) eval (rank 0, rank 1, one process): "
        + ", ".join(f"{k}={ranks[0]['eval'][k]:.6g}/{ranks[1]['eval'][k]:.6g}/{ref[k]:.6g}" for k in fields))
    for k in fields:
        a, b, c = ranks[0]["eval"][k], ranks[1]["eval"][k], ref[k]
        if not (a == b or (math.isnan(a) and math.isnan(b))) or not (abs(a - c) <= 0.01 or (math.isnan(a) and math.isnan(c))):
            raise AssertionError(f"data parallel (b) eval {k}: ranks {a}, {b}, one process {c}")
    mutual_ms = [m["time"] * 1e3 for m in steps[burn_up:]]
    log(f"data parallel (b): {DP_WORLD} gloo ranks sharing one card (host-memory collectives; not representative "
        f"of nccl across cards), {seconds:.1f} s with spawn; mutual iterations {[round(x, 1) for x in mutual_ms]} ms "
        f"against phase 10's one process {[round(x, 1) for x in LOOP_ITER_MS.get('fcos', [])]} ms; card "
        f"{gpu_name_and_power()}")


def dp_nccl_part(device, counts) -> None:
    """(c): the recipe at world size 1 on nccl through parallel.launch, the
    CLI's launcher: DP_NCCL_LOOP iterations, the port waiting for the device
    only at the metrics fetch (torch's sync debug mode, as phase 10)."""
    import shutil

    from ubteacher_tpu_torch.parallel import launch

    first, burn_up = DP_NCCL_LOOP
    max_iter = first + RESUME_STEPS
    out_dir = os.path.join(DP_DIR, "nccl")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    argv = ["--config", CFG, "--num-gpus", "1", "--resume"] + loop_opts(out_dir, max_iter, burn_up, first, 0)
    t0 = time.perf_counter()
    launch(dp_nccl_rank, 1, backend="nccl", args=(out_dir, argv), timeout=DP_TIMEOUT)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "nccl.json")) as f:
        res = json.load(f)
    steps = [m for m in read_lines(out_dir) if "total_loss" in m]
    log(f"data parallel (c): backend {res['backend']}, world {res['world']}, {res['device']}; synchronizing calls by "
        f"site over the resumed run ({RESUME_STEPS} iterations, one checkpoint): {res['sites']}")
    if res["backend"] != "nccl" or res["world"] != 1 or len(steps) != max_iter:
        raise AssertionError(f"data parallel (c): {res['backend']} world {res['world']}, {len(steps)} iterations")
    check_only_metrics_fetch("data parallel (c)", res["sites"], RESUME_STEPS)
    bad = [k for m in steps for k, v in m.items() if k.startswith("loss") and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"data parallel (c): non-finite losses {bad}")
    add_counts(counts, res["counts"])
    log(f"data parallel (c): iterations {[round(m['time'] * 1e3, 1) for m in steps[:first]]} ms, then resumed "
        f"{[round(m['time'] * 1e3, 1) for m in steps[first:]]} ms (mutual) against phase 10's resumed "
        f"{[round(x, 1) for x in LOOP_RESUMED_MS.get('fcos', [])]} ms (mutual, the same batches) in one process "
        f"without a process group; {seconds:.1f} s with spawn; max_memory_allocated {res['peak']} bytes "
        f"({res['peak'] / 2**30:.2f} GiB); launches {res['counts']}; card {gpu_name_and_power()}")
    log(f"data parallel (c): phase 4's FCOS slice steps on this rank (burn-in, boundary, mutual): "
        f"{[round(x, 1) for x in res['step_ms']]} ms against phase 4's mutual steps without a process group "
        f"{[round(x, 1) for x in SLICE_STEP_MS.get('fcos', [])]} ms")


def dp_phase(device):
    """Phase 13: (a), (b), (c); the launch counts of every rank's main path."""
    import shutil

    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    counts = {}
    for part in (dp_small_part, dp_trainer_part, dp_nccl_part):
        t0 = time.perf_counter()
        part(device, counts)
        log(f"data parallel {part.__name__}: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(DP_DIR, ignore_errors=True)
    return counts


# --------------------------------------------------------------------------
# phase 14: the tools
# --------------------------------------------------------------------------

TOOLS_DIR = os.path.join(ROOT, "ubteacher_tpu_torch", "_build", "chip_smoke_tools")
# the kernel phase's device ms a call, by kernel (for the tools phase's log)
KERNEL_MS = {}
# the R-CNN mutual step's ROIAlign forward in the step profile of PERF.md
# section 5: 9.28 ms over 2 launches (tools/profile_step.py on an NVIDIA H100
# 80GB HBM3 at 700 W)
ROI_FWD_IN_STEP_MS = 9.28
LOADER_THREADS = 8
SOAK_ARGS = ["--max-iter", "60", "--kill-at", "40", "--burnin", "20", "--checkpoint-period", "20",
             "--eval-period", "30", "--rss-period", "2", "--timeout", "300"]
MIX_CANVASES = ((768, 1344), (1024, 1344))
MIX_STEPS = 3
EXPORT_CALLS = 5
# the port's packages that configure and build a model: a serving process
# loads none of them
MODEL_CODE = ("config", "modeling", "engine", "evaluation", "data", "checkpoint", "solver", "tools")
# the serving process: torch and the port's ops, nothing else of the port
SERVE = r"""
import json, sys, statistics
import torch
import ubteacher_tpu_torch.ops
from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

program = torch.export.load(sys.argv[1]).module()
inputs = torch.load(sys.argv[2], map_location="cuda:0")
args = (inputs["params"], inputs["images"], inputs["hw"])
reset_launch_counts()
dets = program(*args)
torch.cuda.synchronize()
counts = launch_counts()
ms = []
for _ in range(int(sys.argv[4])):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    program(*args)
    end.record()
    end.synchronize()
    ms.append(start.elapsed_time(end))
port = sorted(m for m in sys.modules if m.startswith("ubteacher_tpu_torch"))
torch.save({"dets": {k: v.cpu() for k, v in dets.items()}, "counts": counts, "ms": statistics.median(ms),
            "modules": port}, sys.argv[3])
"""


def microbench_part(device, counts) -> None:
    """tools/microbench_rcnn.py at its defaults: the R-CNN stages alone."""
    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.tools import microbench_rcnn

    reset_launch_counts()
    out = microbench_rcnn.main([])
    got = launch_counts()
    add_counts(counts, got)
    missing = [k for k in ("matcher", "nms", "roi_align_fwd", "roi_align_bwd") if not got[k]]
    if missing:
        raise AssertionError(f"microbench_rcnn: kernels not launched: {missing}")
    fwd = next(v for k, v in out["rows"].items() if k.startswith("roi_align fwd ("))
    standalone = KERNEL_MS.get("roi_align_fwd")
    log(f"microbench_rcnn: ROIAlign forward {fwd['median_ms']:.4f} ms (min {fwd['min_ms']:.4f}) over "
        f"{out['batch']} x 512 rois; the kernel phase's standalone call over {RCNN_STUDENT} x {RCNN_ROIS} rois "
        + (f"{standalone:.4f} ms" if standalone is not None else "not measured in this run")
        + f"; in the R-CNN step's profile (PERF.md section 5) {ROI_FWD_IN_STEP_MS} ms over 2 launches; launches "
        f"{got}")
    bad = [k for k, v in out["rows"].items() if not (math.isfinite(v["median_ms"]) and v["median_ms"] > 0)]
    if bad:
        raise AssertionError(f"microbench_rcnn: rows without a time: {bad}")
    roi_fwd_in_step(device, counts)


def roi_fwd_in_step(device, counts) -> None:
    """The ROIAlign forward calls of one full-width R-CNN mutual step (8 + 8
    at 768x1344, phase 6's seeded setup), recorded with their inputs and
    each timed alone on them: what the step's profile row of the forward is
    made of."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, roi_align_cuda

    _, (burnin, mutual), state, batch = common.step_setup(True, device)
    state, _ = burnin(state, batch)
    state, _ = mutual(state, batch)  # the first mutual step: not recorded
    torch.cuda.synchronize()
    calls = []
    real = roi_align_cuda.roi_align_forward_kernel

    def record(feats, boxes, level, *args):
        calls.append(([f.clone() for f in feats], boxes.clone(), level.clone(), args))
        return real(feats, boxes, level, *args)

    reset_launch_counts()
    roi_align_cuda.roi_align_forward_kernel = record
    try:
        state, _ = mutual(state, batch)
        torch.cuda.synchronize()
    finally:
        roi_align_cuda.roi_align_forward_kernel = real
    add_counts(counts, launch_counts())
    total = 0.0
    for i, (feats, boxes, level, args) in enumerate(calls):
        ms = median_ms(lambda: real(feats, boxes, level, *args))
        total += ms
        side = ((boxes[:, 2] - boxes[:, 0]).clamp_min(0) * (boxes[:, 3] - boxes[:, 1]).clamp_min(0)).sqrt()
        per_level = torch.bincount(level.long(), minlength=len(feats)).tolist()
        log(f"ROIAlign forward in the R-CNN mutual step, call {i}: {boxes.shape[0]} rois of {feats[0].shape[0]} "
            f"images ({feats[0].dtype}), per level {per_level}, sqrt(area) median {side.median().item():.1f} px, "
            f"max {side.max().item():.1f}; alone {ms:.4f} ms")
    log(f"ROIAlign forward in the R-CNN mutual step: {len(calls)} calls, {total:.4f} ms alone on the step's own "
        f"inputs; card {gpu_name_and_power()}")
    del state, batch, calls
    torch.cuda.empty_cache()


def loader_part(device, counts) -> None:
    """tools/bench_loader.py --once at 8 threads, then one --concurrent-step
    window (the FCOS mutual step looping on the card beside the loader)."""
    import shutil

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.tools import bench_loader

    work = os.path.join(TOOLS_DIR, "loader")
    shutil.rmtree(work, ignore_errors=True)
    alone = bench_loader.main(["--once", "--threads", str(LOADER_THREADS), "--images", "200", "--workdir", work])
    reset_launch_counts()
    during = bench_loader.main(["--once", "--threads", str(LOADER_THREADS), "--images", "200", "--workdir", work,
                                "--concurrent-step"])
    got = launch_counts()
    add_counts(counts, got)
    missing = [k for k in FCOS_KERNELS if not got[k]]
    if missing or during[0]["step_s"] <= 0 or alone[0]["img_s"] <= 0 or alone[0]["corrupt"]:
        raise AssertionError(f"bench_loader: alone {alone}, during {during}, kernels not launched {missing}")
    log(f"bench_loader: {alone[0]['img_s']} img/s alone at {LOADER_THREADS} threads, {during[0]['loader_img_s']} "
        f"img/s beside the FCOS mutual step at {during[0]['step_s']} steps/s "
        f"({during[0]['device_img_s_during']} img/s); launches {got}")
    shutil.rmtree(work, ignore_errors=True)


def soak_part(device, counts) -> None:
    """A short tools/soak.py at the recipe's geometry: the child trains, is
    killed at a checkpoint, and this process resumes it bitwise to the end."""
    import shutil

    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.tools import soak

    work = os.path.join(TOOLS_DIR, "soak")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()  # the child shares the card
    reset_launch_counts()
    summary = soak.main(SOAK_ARGS + ["--workdir", work])
    got = launch_counts()
    add_counts(counts, got)
    for row in summary["first_use"]:
        log(f"soak first use: {row}")
    log("soak: " + json.dumps({k: v for k, v in summary.items() if k != "first_use"}))
    if not (summary["resume_hash_bitwise_equal"] and summary["reached_max_iter"] and summary["final_losses_finite"]):
        raise AssertionError(f"soak: hash equal {summary['resume_hash_bitwise_equal']}, reached MAX_ITER "
                             f"{summary['reached_max_iter']}, losses finite {summary['final_losses_finite']}")
    missing = [k for k in FCOS_KERNELS if not got[k]]
    if missing:
        raise AssertionError(f"soak: kernels not launched in the resumed run: {missing}")
    shutil.rmtree(work, ignore_errors=True)


def recipe_part(device, counts) -> None:
    """The FCOS mutual step at each bucket canvas (8 + 8), then
    tools/recipe_mix.py fed those ms."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.tools import recipe_mix

    argv = []
    for canvas in MIX_CANVASES:
        _, (burnin, mutual), state, batch = common.step_setup(False, device, canvas=canvas)
        state, _ = burnin(state, batch)
        state, _ = mutual(state, batch)  # the canvas's first mutual step: not timed
        torch.cuda.synchronize()
        reset_launch_counts()
        ms = []
        for _ in range(MIX_STEPS):
            t0 = time.perf_counter()
            state, metrics = mutual(state, batch)
            float(metrics["total_loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        add_counts(counts, launch_counts())
        log(f"recipe_mix: FCOS mutual step at {canvas[0]}x{canvas[1]}: {[round(x, 1) for x in ms]} ms")
        argv += ["--ms", str(canvas[0]), str(canvas[1]), str(statistics.median(ms))]
        del state, batch
        torch.cuda.empty_cache()
    out = recipe_mix.main(argv)
    if "effective_img_s_chip" not in out:
        raise AssertionError(f"recipe_mix: {out}")
    log(f"recipe_mix: {out}; card {gpu_name_and_power()}")


def export_part(device, counts) -> None:
    """tools/export_inference.py for both detectors at 800x1344, batch 8,
    the fused stem: the artifact loaded in a fresh process that imports
    torch and the port's ops only; its detections against the eager
    inference function's on the same weights and images, and the CUDA
    kernels it launched."""
    import torch

    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.tools import export_inference as export

    os.makedirs(TOOLS_DIR, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(5)
    h, w = EVAL_CANVAS
    images = (torch.randn((EVAL_BATCH, h, w, 3), generator=gen, device=device) * 45 + 110).clamp(0, 255)
    hw = torch.tensor([[h, w]] * (EVAL_BATCH // 2) + [[600, 900]] * (EVAL_BATCH // 2), dtype=torch.float32,
                      device=device)
    for rcnn in (False, True):
        name = "rcnn" if rcnn else "fcos"
        cfg = load_cfg(["TPU.STEM_MODE", "pallas"], RCNN_CFG if rcnn else CFG)
        path = os.path.join(TOOLS_DIR, f"{name}_infer.pt2")
        t0 = time.perf_counter()
        size = export.save(export.export_program(cfg, rcnn, EVAL_BATCH, EVAL_CANVAS, device), path)
        t_export = time.perf_counter() - t0
        model = (build_rcnn_model(cfg, device, 0, RCNN_SLICE_CLS_BIAS) if rcnn
                 else build_fcos_model(cfg, device, 0, SLICE_CLS_BIAS)).eval()
        infer = export.inference_fn(cfg, rcnn)
        reset_launch_counts()
        with torch.inference_mode():
            ref = vars(infer(model, images, hw))
            torch.cuda.synchronize()
            add_counts(counts, launch_counts())
            eager_ms = median_ms(lambda: infer(model, images, hw), runs=EXPORT_CALLS, sample_ms=0.0)
        inputs = os.path.join(TOOLS_DIR, f"{name}_inputs.pt")
        torch.save({"params": dict(model.state_dict()), "images": images, "hw": hw}, inputs)
        result = os.path.join(TOOLS_DIR, f"{name}_served.pt")
        proc = subprocess.run([sys.executable, "-c", SERVE, path, inputs, result, str(EXPORT_CALLS)],
                              cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"export {name}: the serving process failed:\n{proc.stderr[-4000:]}")
        served = torch.load(result, weights_only=False)
        add_counts(counts, served["counts"])
        extra = [m for m in served["modules"] if m.split(".")[1:2] and m.split(".")[1] in MODEL_CODE]
        bitwise = {k: same_bytes(v.cpu(), served["dets"][k]) for k, v in ref.items()}
        errs = {k: float((v.cpu().double() - served["dets"][k].double()).abs().max())
                for k, v in ref.items() if v.is_floating_point() and v.numel()}
        need = ("nms", "stem") + (("roi_align_fwd",) if rcnn else ())
        log(f"export {name}: {size} bytes, traced in {t_export:.1f} s; served call {served['ms']:.3f} ms against "
            f"eager {eager_ms:.3f} ms (median of {EXPORT_CALLS}); bitwise {bitwise}; max abs diff {errs}; "
            f"served launches {served['counts']}; modules of the port loaded to serve {served['modules']}")
        mask = ref["mask"].cpu()
        if (not torch.equal(mask, served["dets"]["mask"]) or not mask.any()
                or not torch.equal(ref["classes"].cpu()[mask], served["dets"]["classes"][mask])
                or errs.get("boxes", 0.0) > 5e-3 or errs.get("scores", 0.0) > 1e-5):
            raise AssertionError(f"export {name}: served detections differ from eager: {bitwise}, {errs}")
        missing = [k for k in need if not served["counts"].get(k)]
        if missing or extra:
            raise AssertionError(f"export {name}: kernels not launched {missing}; model-building modules "
                                 f"loaded to serve: {extra}")
        for p in (path, inputs, result):
            os.remove(p)
        del model
        torch.cuda.empty_cache()


def tools_phase(device):
    """Phase 14: the five tools through their entry points; the launch
    counts of their main-path runs."""
    import shutil

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    counts = {}
    for part in (microbench_part, loader_part, soak_part, recipe_part, export_part):
        t0 = time.perf_counter()
        part(device, counts)
        log(f"tools {part.__name__}: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    return counts


# the tools run on their own: python3 chip_smoke.py <flag>; each prints no result line
TOOLS = {
    "--profile-rcnn": lambda device: profile_step.run(True, device),
    "--profile-fcos": lambda device: profile_step.run(False, device),
    "--lift": run_lifts,
    "--ab-stem": lambda device: ab_stem.run(device),
    "--mfu": lambda device: mfu.main([]),
    "--data-parallel": dp_phase,
    "--tools": tools_phase,
}


def main() -> int:
    common.triton_cache_in_checkout()
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
    if len(sys.argv) == 2 and sys.argv[1] in TOOLS:
        TOOLS[sys.argv[1]](device)
        log(name_power)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    counts = {}
    phases = (("kernel", kernel_phase), ("fcos reference", reference_phase), ("fcos slice", slice_phase),
              ("rcnn reference", rcnn_reference_phase), ("rcnn slice", rcnn_slice_phase),
              ("eval reference", eval_reference_phase), ("fcos eval slice", fcos_eval_slice_phase),
              ("rcnn eval slice", rcnn_eval_slice_phase), ("fcos train loop", fcos_loop_phase),
              ("rcnn train loop", rcnn_loop_phase), ("fcos lift", lift_phase), ("data parallel", dp_phase),
              ("tools", tools_phase))
    for name, phase in phases:
        t0 = time.perf_counter()
        out = phase(device)
        torch.cuda.empty_cache()
        log(f"{name} phase {time.perf_counter() - t0:.1f} s")
        if name == "kernel":
            kernels = out
            KERNEL_MS.update({k["name"]: k["ms"] for k in out})
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
