"""Greedy NMS on score-sorted candidates: the plain version, on any device."""

from __future__ import annotations

import torch


def nms_sorted_keep_plain(
    sboxes: torch.Tensor, nvalid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Plain version of the kernel: the same division-free compare over the
    full (B, K, K) overlap matrix, then the greedy loop over sorted rows."""
    b, k = sboxes.shape[:2]
    x1, y1, x2, y2 = sboxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    iw = torch.clamp(
        torch.minimum(x2[:, :, None], x2[:, None, :]) - torch.maximum(x1[:, :, None], x1[:, None, :]),
        min=0.0,
    )
    ih = torch.clamp(
        torch.minimum(y2[:, :, None], y2[:, None, :]) - torch.maximum(y1[:, :, None], y1[:, None, :]),
        min=0.0,
    )
    inter = iw * ih
    union = (area[:, :, None] + area[:, None, :]) - inter
    idx = torch.arange(k, device=sboxes.device)
    valid = idx[None, :] < nvalid[:, None]
    # row i (earlier in score order) may suppress only later valid column j
    over = (inter > iou_threshold * union) & (idx[:, None] < idx[None, :]) & valid[:, None, :]
    suppressed = torch.zeros((b, k), dtype=torch.bool, device=sboxes.device)
    keep = torch.zeros((b, k), dtype=torch.bool, device=sboxes.device)
    for i in range(int(nvalid.max()) if b and k else 0):
        keep_i = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = keep_i
        suppressed |= over[:, i, :] & keep_i[:, None]
    return keep


nms_sorted_keep = nms_sorted_keep_plain
