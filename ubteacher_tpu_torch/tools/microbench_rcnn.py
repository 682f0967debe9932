"""Time the Faster R-CNN step's non-conv stages one at a time (port of the
JAX package's tools/microbench_rcnn.py).

The stages of the RPN / ROI machinery at the train shapes: the fused
student batch of 2 x --batch images (labeled + unlabeled strong) on the
768x1344 canvas, 100 gt slots with 12 live, the RPN's 2,000 candidates at
IoU 0.7, 512 rois per image on p2-p5 in bfloat16:

  label_anchors (matcher + sampling)   the matcher kernel (csrc/matcher.cu),
                                       the sampling draws and label_anchors
  match_quality + match only           the plain matcher (torch)
  match_anchors_batched (dispatch)     the matcher kernel alone
  find_top_proposals                   top-k, decode, NMS (csrc/nms.cu)
  roi_align fwd                        csrc/roi_align.cu forward
  roi_align fwd+bwd                    forward and backward kernels
  batched_nms_keep (2000 cand)         csrc/nms.cu

The JAX tool chains K iterations in one jitted fori_loop and keeps the
minimum, since its pooled chip was noisy. Here each trial times --iters
back-to-back calls between two CUDA events after a warm-up call (on the
CPU, the host clock around them), and a row reports the median and the
minimum over --trials trials of the ms a call. The inputs come from
numpy's default_rng(0) in the JAX tool's order, so a stage here and there
see the same values. Runs on the first card unless --cpu. The last line is
one JSON object of every row.

Usage: python -m ubteacher_tpu_torch.tools.microbench_rcnn [--batch 4] [--canvas 768 1344]
           [--iters 10] [--trials 4] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict

import numpy as np
import torch

from .common import device_label, tool_device, triton_cache_in_checkout

MAX_GT = 100
LIVE_GT = 12
ROIS = 512
CHANNELS = 256
CANDIDATES = 2000
STRIDES = (4, 8, 16, 32, 64)
SIZES = [[32], [64], [128], [256], [512]]
RATIOS = [[0.5, 1.0, 2.0]]


def make_inputs(b: int, canvas, seed: int = 0, feat_dtype=np.float32, rois: int = ROIS,
                channels: int = CHANNELS) -> Dict[str, np.ndarray]:
    """Every stage's inputs as numpy arrays, drawn in the JAX tool's order:
    gt boxes (b, MAX_GT, 4) and mask, RPN logits and deltas, the p2-p5
    pyramid (NHWC, `channels` wide, in `feat_dtype`), `rois` rois an image,
    NMS candidates and
    scores. Box sizes and margins are the JAX tool's on a canvas of 768 or
    more a side, and shrink with a smaller one (which the JAX tool's draws
    do not fit)."""
    h, w = canvas
    k = min(1.0, min(h, w) / 768.0)
    rng = np.random.default_rng(seed)
    a_cell = len(RATIOS[0])
    nloc = sum(((h + s - 1) // s) * ((w + s - 1) // s) for s in STRIDES)
    out = {}
    gt = np.zeros((b, MAX_GT, 4), np.float32)
    nb = LIVE_GT
    gt[:, :nb, 0] = rng.uniform(0, w - 200 * k, (b, nb))
    gt[:, :nb, 1] = rng.uniform(0, h - 200 * k, (b, nb))
    gt[:, :nb, 2] = gt[:, :nb, 0] + rng.uniform(20 * k, 200 * k, (b, nb))
    gt[:, :nb, 3] = gt[:, :nb, 1] + rng.uniform(20 * k, 200 * k, (b, nb))
    mask = np.zeros((b, MAX_GT), bool)
    mask[:, :nb] = True
    out["gt_boxes"], out["gt_mask"] = gt, mask
    out["logits"] = rng.normal(0, 1, (b, nloc, a_cell)).astype(np.float32)
    out["deltas"] = rng.normal(0, 0.1, (b, nloc, a_cell, 4)).astype(np.float32)
    for i, s in enumerate((4, 8, 16, 32)):
        out[f"p{i + 2}"] = rng.normal(0, 1, (b, h // s, w // s, channels)).astype(np.float32).astype(feat_dtype)
    n_rois = rois
    rois = np.zeros((b, n_rois, 4), np.float32)
    rois[..., 0] = rng.uniform(0, w - 64 * k, (b, n_rois))
    rois[..., 1] = rng.uniform(0, h - 64 * k, (b, n_rois))
    rois[..., 2] = rois[..., 0] + rng.uniform(8 * k, 300 * k, (b, n_rois))
    rois[..., 3] = rois[..., 1] + rng.uniform(8 * k, 300 * k, (b, n_rois))
    out["rois"] = rois
    cboxes = np.zeros((b, CANDIDATES, 4), np.float32)
    cboxes[..., 0] = rng.uniform(0, w - 64 * k, (b, CANDIDATES))
    cboxes[..., 1] = rng.uniform(0, h - 64 * k, (b, CANDIDATES))
    cboxes[..., 2] = cboxes[..., 0] + rng.uniform(8 * k, 300 * k, (b, CANDIDATES))
    cboxes[..., 3] = cboxes[..., 1] + rng.uniform(8 * k, 300 * k, (b, CANDIDATES))
    out["cboxes"] = cboxes
    out["cscores"] = rng.uniform(0, 1, (b, CANDIDATES)).astype(np.float32)
    return out


def stages(inputs: Dict[str, np.ndarray], canvas, device, feat_dtype=torch.bfloat16, seed: int = 0):
    """{row name: a call of that stage on `device`} over `inputs`
    (make_inputs), each returning its output."""
    from ..modeling.anchors import generate_anchors
    from ..modeling.box_regression import Box2BoxTransform
    from ..modeling.matcher import match, match_anchors_batched, match_quality
    from ..modeling.rpn import anchor_validity, find_top_proposals, label_anchors
    from ..ops.nms import batched_nms_keep
    from ..ops.roi_align import multilevel_roi_align
    from ..structures import PaddedInstances

    h, w = canvas

    def dev(x, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return t if dtype is None else t.to(dtype)

    anch = generate_anchors((h, w), STRIDES, SIZES, RATIOS, device=device)
    anchors = anch["anchors"]
    gt_boxes, gt_mask = dev(inputs["gt_boxes"]), dev(inputs["gt_mask"])
    b, m = gt_mask.shape
    gt = PaddedInstances(gt_boxes, torch.zeros((b, m), dtype=torch.int64, device=device),
                         torch.ones((b, m), device=device), torch.zeros((b, m, 4), device=device), gt_mask)
    hw = torch.tensor([[float(h), float(w)]], device=device).expand(b, 2).contiguous()
    valid = anchor_validity(anch["cell_origins"], hw)
    gen = torch.Generator(device=device).manual_seed(seed)
    box2box = Box2BoxTransform((1.0, 1.0, 1.0, 1.0))
    logits, deltas = dev(inputs["logits"]), dev(inputs["deltas"])
    # the pyramid NCHW, as the port's FPN gives it
    pyramid = [dev(inputs[f"p{i}"]).permute(0, 3, 1, 2).contiguous().to(feat_dtype) for i in (2, 3, 4, 5)]
    grad_pyramid = [p.detach().requires_grad_() for p in pyramid]
    rois = dev(inputs["rois"])
    cboxes, cscores = dev(inputs["cboxes"]), dev(inputs["cscores"])
    clvls = torch.zeros((b, cboxes.shape[1]), dtype=torch.int64, device=device)
    cvalid = torch.ones((b, cboxes.shape[1]), dtype=torch.bool, device=device)

    def run_label():
        matched = match_anchors_batched(anchors, gt.boxes, gt.mask)
        priorities = torch.rand((b, 2, anchors.shape[0]), generator=gen, device=device)
        return label_anchors(gt, 256, 0.5, priorities, False, valid, matched)

    def run_match():
        return match(match_quality(gt.boxes, gt.mask, anchors), (0.3, 0.7), (0, -1, 1), allow_low_quality=True)

    def run_match_fast():
        return match_anchors_batched(anchors, gt.boxes, gt.mask)

    def run_props():
        return find_top_proposals(anchors, anch["level_lengths"], logits, deltas, hw, box2box, 12000, 2000, 0.7,
                                  total_candidates=2000, cell_origins=anch["cell_origins"])

    def run_pool():
        return multilevel_roi_align(pyramid, rois, (2, 3, 4, 5), 7, 0)

    def run_pool_grad():
        out = multilevel_roi_align(grad_pyramid, rois, (2, 3, 4, 5), 7, 0)
        return torch.autograd.grad(out, grad_pyramid, torch.ones_like(out), allow_unused=True)

    def run_nms():
        return batched_nms_keep(cboxes, cscores, clvls, cvalid, 0.7)

    return {
        "label_anchors (matcher+sample)": run_label,
        "match_quality+match only": run_match,
        "match_anchors_batched (dispatch)": run_match_fast,
        "find_top_proposals": run_props,
        f"roi_align fwd ({b}x{rois.shape[1]} rois)": run_pool,
        "roi_align fwd+bwd": run_pool_grad,
        f"batched_nms_keep ({cboxes.shape[1]} cand)": run_nms,
    }


def timed(fn: Callable, device, iters: int, trials: int) -> Dict[str, float]:
    """{"median_ms", "min_ms"} a call over `trials` trials of `iters`
    back-to-back calls, after one warm-up call; CUDA events on the card,
    the host clock on the CPU (where a call returns when it is done)."""
    fn()
    per_call = []
    for _ in range(trials):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    return {"median_ms": statistics.median(per_call), "min_ms": min(per_call)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--canvas", type=int, nargs=2, default=(768, 1344))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = tool_device(args.cpu)
    triton_cache_in_checkout()
    canvas = tuple(args.canvas)
    # the student runs labeled + unlabeled strong in one fused forward
    b = 2 * args.batch
    runs = stages(make_inputs(b, canvas, rois=ROIS, channels=CHANNELS), canvas, device)
    n_anchors = sum(((canvas[0] + s - 1) // s) * ((canvas[1] + s - 1) // s) for s in STRIDES) * len(RATIOS[0])
    print(f"batch {b} (fused student), anchors {n_anchors}, canvas {canvas[0]}x{canvas[1]}, "
          f"{device_label(device)}")
    rows = {}
    for name, fn in runs.items():
        rows[name] = timed(fn, device, args.iters, args.trials)
        print(f"{name:34s} {rows[name]['median_ms']:8.3f} ms (min {rows[name]['min_ms']:.3f})", flush=True)
    out = {"batch": b, "canvas": list(canvas), "anchors": n_anchors, "iters": args.iters, "trials": args.trials,
           "device": device_label(device), "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
