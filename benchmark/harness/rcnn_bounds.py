"""The least time the R-CNN cell's ROI kernels could take on the card: the
bytes that must cross HBM and the operations that must be done, from the
calls the harness recorded (harness/rcnn_train_cell.py), never from the
kernels' own code, against the card's published peaks (harness/peaks.py).
A kernel's roofline share is this bound over its traced time.

ROIAlign, per call (rois N, channels C, P x P bins, feature bytes s):
  * footprint: the pixels a roi's bilinear samples touch on its level (the
    taps floor(pos) and floor(pos) + 1 of every sample position along each
    axis, positions as the plain reference computes them), united over the
    rois of each image and level: each such pixel must be read once;
  * forward bytes: footprint x C x s read, N x P x P x C x s written;
    backward bytes: the pooled gradient N x P x P x C x s read, the
    footprint x C x s of gradient written (a design that adds into an
    existing gradient need write nothing else);
  * operations, either direction: per roi the fewer of the direct form
    (P^2 x S_y x S_x samples x 4 taps x 2 x C) and the separable one
    (2 C P (T_y T_x + P T_y), T the touched rows and columns), at the
    float32 peak (the contraction runs on the CUDA cores).
Anchor matcher (the two kernels of one call: the per-gt best and the
labels), per call: anchors A x 16 bytes and gt B x M x 17 bytes read, the
(B, A) matched index and label written; operations: 12 for the IoU of each
(anchor, valid gt) pair that overlaps (no other pair's IoU needs
computing), at the float32 peak."""

from __future__ import annotations

from typing import Dict, List

import torch

IOU_OPS = 12


def _touched(start: torch.Tensor, extent: torch.Tensor, p: int, sampling_ratio: int, length: int):
    """(N, length) bool: the rows (or columns) a roi's taps touch, and the
    per-roi sample count per bin (N,)."""
    from ..reference.ubtref.ops.roi_align import bin_sample_positions

    pos, coef = bin_sample_positions(start, extent, p, sampling_ratio)
    pos = pos.clamp(0.0, length - 1.0)
    lo = torch.floor(pos).long()
    taps = torch.cat([lo, (lo + 1).clamp(max=length - 1)], -1).reshape(start.shape[0], -1)
    rows = torch.zeros((start.shape[0], length), dtype=torch.bool, device=start.device).scatter_(1, taps, True)
    return rows, (coef > 0).sum(-1)[:, 0]


def roi_align_call(boxes: torch.Tensor, shapes, dtype_bytes: int, levels=(2, 3, 4, 5), output_size: int = 7,
                   sampling_ratio: int = 0) -> Dict[str, float]:
    """{footprint_px, out_elems, ops} of one multilevel_roi_align call:
    boxes (B, R, 4) image pixels, shapes the levels' (B, C, H, W)."""
    from ..reference.ubtref.ops.roi_align import assign_levels

    b, r, _ = boxes.shape
    c, p = shapes[0][1], output_size
    flat = boxes.reshape(b * r, 4).float()
    level = assign_levels(flat, min(levels), max(levels)) - min(levels)
    img = torch.arange(b * r, device=flat.device) // r
    footprint, ops = 0.0, 0.0
    for lv, (_, _, h, w) in enumerate(shapes):
        scale = 1.0 / 2 ** levels[lv]
        for i in range(b):
            sel = (level == lv) & (img == i)
            if not bool(sel.any()):
                continue
            bx = flat[sel] * scale - 0.5
            ys, sy = _touched(bx[:, 1], torch.clamp(bx[:, 3] - bx[:, 1], min=1e-6), p, sampling_ratio, h)
            xs, sx = _touched(bx[:, 0], torch.clamp(bx[:, 2] - bx[:, 0], min=1e-6), p, sampling_ratio, w)
            footprint += float(((ys.float().T @ xs.float()) > 0).sum())
            ty, tx = ys.sum(1).double(), xs.sum(1).double()
            direct = p * p * sy.double() * sx.double() * 4 * 2 * c
            separable = 2.0 * c * p * (ty * tx + p * ty)
            ops += float(torch.minimum(direct, separable).sum())
    return {"footprint_px": footprint, "out_elems": float(b * r * p * p * c), "channels": float(c),
            "dtype_bytes": float(dtype_bytes), "ops": ops}


def match_call(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
               out_bytes: int) -> Dict[str, float]:
    """{bytes, ops} of one anchor-matcher call: anchors (A, 4), gt (B, M)."""
    from ..reference.ubtref.ops.boxes import pairwise_iou

    a = anchor_boxes.shape[0]
    b, m = gt_mask.shape
    overlapping = 0.0
    for i in range(b):
        g = gt_boxes[i][gt_mask[i]].float()
        if g.shape[0]:
            overlapping += float((pairwise_iou(g, anchor_boxes.float()) > 0).sum())
    return {"bytes": float(a * 16 + b * m * 17 + b * a * out_bytes), "ops": overlapping * IOU_OPS}


def bounds_s(calls: Dict[str, List[dict]], peak: Dict[str, float]) -> Dict[str, float]:
    """{roi_align_fwd_s, roi_align_bwd_s, match_s}: each kernel's least
    seconds over the recorded calls (the traced iterations')."""
    bw, fp32 = peak["hbm_bytes_s"], peak["fp32_flops"]
    fwd = bwd = match = 0.0
    for call in calls.get("roi_align", []):
        kw = dict(zip(("levels", "output_size", "sampling_ratio"), call["args"]), **call["kwargs"])
        c = roi_align_call(call["boxes"], call["shapes"], call["dtype_bytes"], **kw)
        foot = c["footprint_px"] * c["channels"] * c["dtype_bytes"]
        pooled = c["out_elems"] * c["dtype_bytes"]
        fwd += max((foot + pooled) / bw, c["ops"] / fp32)
        if call["backward"]:
            bwd += max((pooled + foot) / bw, c["ops"] / fp32)
    for call in calls.get("match", []):
        c = match_call(call["anchor_boxes"], call["gt_boxes"], call["gt_mask"], call["out_bytes"])
        match += max(c["bytes"] / bw, c["ops"] / fp32)
    return {"roi_align_fwd_s": fwd, "roi_align_bwd_s": bwd, "match_s": match}
