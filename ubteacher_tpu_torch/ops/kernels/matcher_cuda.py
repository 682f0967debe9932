"""Batched anchor matcher: the CUDA kernel (`csrc/matcher.cu`) and its plain
PyTorch version.

Replaces ubteacher_tpu/ops/pallas/matcher_pallas.py:match_anchors_pallas
(_gm_kernel, _match_kernel): per image and anchor, the best IoU over the
valid gt boxes and its first argmax, threshold labels, and the
allow-low-quality promotion. What bounds it on the H100 and what the design
does about it is set out at the head of csrc/matcher.cu: each warp of 32
consecutive anchors computes only the gt slots whose boxes can meet its
anchors (`warp_candidates` is that rule in plain PyTorch). Its results are
bitwise those of the plain version, `pairwise_iou` + `match`
(modeling/matcher.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

LAUNCHES = {"matcher": 0}

WARP = 32  # consecutive anchors that share one candidate mask


def bind(path: str) -> ctypes.CDLL:
    """Load a build of csrc/matcher.cu and declare its C interface."""
    lib = ctypes.CDLL(path)
    fn = lib.ubt_match_anchors
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, p, i, i, f, f, i, i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(build.build("matcher"))


def match_anchors_kernel(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    thresholds: Sequence[float] = (0.3, 0.7),
    labels: Sequence[int] = (0, -1, 1),
    allow_low_quality: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. anchors (A, 4) f32, gt_boxes (B, M, 4) f32,
    gt_mask (B, M) bool, all contiguous on one CUDA device. Returns
    (matched_idxs, labels), each (B, A) int64."""
    dev = anchors.device
    if not anchors.is_cuda or gt_boxes.device != dev or gt_mask.device != dev:
        raise ValueError("match_anchors_kernel: tensors must be on one CUDA device")
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32 or gt_mask.dtype != torch.bool:
        raise TypeError(
            f"match_anchors_kernel: expected float32 anchors and boxes and a bool mask, got "
            f"{anchors.dtype}, {gt_boxes.dtype}, {gt_mask.dtype}"
        )
    if (anchors.dim() != 2 or anchors.shape[1] != 4 or gt_boxes.dim() != 3 or gt_boxes.shape[2] != 4
            or gt_mask.shape != gt_boxes.shape[:2]):
        raise ValueError(
            f"match_anchors_kernel: expected (A, 4), (B, M, 4), (B, M), got {tuple(anchors.shape)}, "
            f"{tuple(gt_boxes.shape)}, {tuple(gt_mask.shape)}"
        )
    if len(thresholds) != 2 or len(labels) != 3:
        raise ValueError("match_anchors_kernel: takes two thresholds and three labels")
    if not (anchors.is_contiguous() and gt_boxes.is_contiguous() and gt_mask.is_contiguous()):
        raise ValueError("match_anchors_kernel: tensors must be contiguous")
    if anchors.data_ptr() % 16 or gt_boxes.data_ptr() % 16:
        raise ValueError("match_anchors_kernel: boxes must be 16-byte aligned")
    a = anchors.shape[0]
    b, m = gt_mask.shape
    if 25 * m + 8 > 48 * 1024 or b > 65535:
        raise ValueError(f"match_anchors_kernel: B={b}, M={m} exceed the launch limits")
    gm = torch.empty((b, m), dtype=torch.int32, device=dev)  # scratch: each gt's best IoU bits
    idx = torch.empty((b, a), dtype=torch.int64, device=dev)
    lab = torch.empty((b, a), dtype=torch.int64, device=dev)
    if b == 0 or a == 0:
        return idx, lab
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ubt_match_anchors(
            anchors.data_ptr(), a, gt_boxes.data_ptr(), gt_mask.data_ptr(), b, m,
            float(thresholds[0]), float(thresholds[1]), int(labels[0]), int(labels[1]), int(labels[2]),
            int(bool(allow_low_quality)), gm.data_ptr(), idx.data_ptr(), lab.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"matcher kernel launch failed: CUDA error {err}")
    LAUNCHES["matcher"] += 1
    return idx, lab


def warp_candidates(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """The kernel's culling rule: (B, ceil(A / 32), M) bool, True where gt
    slot j is a candidate of the warp of anchors 32 w .. 32 w + 31: a valid
    slot whose box meets the warp's union rectangle (closed intersection) or
    has a non-finite coordinate. The kernel computes the IoU of those pairs
    only; every other valid pair's IoU is exactly 0."""
    a = anchors.shape[0]
    pad = -a % WARP
    lo = F.pad(anchors[:, :2], (0, 0, 0, pad), value=float("inf")).view(-1, WARP, 2).amin(1)
    hi = F.pad(anchors[:, 2:], (0, 0, 0, pad), value=float("-inf")).view(-1, WARP, 2).amax(1)
    g = gt_boxes[:, None]  # (B, 1, M, 4)
    meets = ((g[..., 0] <= hi[None, :, None, 0]) & (g[..., 2] >= lo[None, :, None, 0])
             & (g[..., 1] <= hi[None, :, None, 1]) & (g[..., 3] >= lo[None, :, None, 1]))
    return gt_mask[:, None] & (meets | ~torch.isfinite(g).all(-1))


def match_anchors_plain(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    thresholds: Sequence[float] = (0.3, 0.7),
    labels: Sequence[int] = (0, -1, 1),
    allow_low_quality: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the (B, M, A) quality matrix of pairwise_iou, then
    match over the gt axis."""
    from ...modeling.matcher import match, match_quality

    quality = match_quality(gt_boxes, gt_mask, anchors)
    return match(quality, thresholds, labels, allow_low_quality)


def match_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    thresholds: Sequence[float] = (0.3, 0.7),
    labels: Sequence[int] = (0, -1, 1),
    allow_low_quality: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(matched_idxs, labels), each (B, A) int64. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if anchors.device.type == "cpu":
        return match_anchors_plain(anchors, gt_boxes, gt_mask, thresholds, labels, allow_low_quality)
    return match_anchors_kernel(anchors, gt_boxes, gt_mask, thresholds, labels, allow_low_quality)
