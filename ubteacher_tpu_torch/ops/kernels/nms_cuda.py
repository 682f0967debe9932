"""Greedy NMS on score-sorted candidates: the CUDA bitmask kernel
(`csrc/nms.cu`) and its plain PyTorch version.

Replaces ubteacher_tpu/ops/pallas/nms_pallas.py:nms_keep_pallas
(_nms_core / _nms_kernel). What bounds it on the H100 and what the design does
about it is set out at the head of csrc/nms.cu. The all-pairs overlap test is
little arithmetic; the greedy pass is a latency chain of one step per 64-row
tile. So the overlap bits are computed in parallel over (tile, tile, image)
into 64-bit words stored column-word-major (B, words, K), which makes both
the stores and the sweep's loads coalesced; then one block per image sweeps
the tiles, one warp resolving each tile's chain by a fixpoint of warp-wide
OR-reductions while the others have already loaded the words they fold into
the later tiles. The work is bounded by each image's valid count.

Sorting, the class-offset trick and the scatter back to input order stay in
torch (ops/nms.py), as they sit outside the Pallas call in JAX.

The library is built on first use with nvcc (ops/kernels/build.py), from the
sources in this package only, into `ubteacher_tpu_torch/_build/`, and loaded
with ctypes. The kernel and its plain version are the CUDA and CPU
implementations of the torch.library op `ubt::nms_sorted_keep`, with a
shape function for tracing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LAUNCHES = {"nms": 0}

_TILE = 64
_MAX_WORDS = 6144  # the sweep keeps one 64-bit word per tile in 48 KB of shared memory


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build.build("nms"))
    fn = lib.ubt_nms_keep_sorted
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def nms_sorted_keep_kernel(
    sboxes: torch.Tensor, nvalid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Launch the CUDA kernel. sboxes (B, K, 4) f32 xyxy sorted by score
    descending with each image's nvalid valid rows first; nvalid (B,) int32.
    Returns keep (B, K) bool in sorted order."""
    if not sboxes.is_cuda or nvalid.device != sboxes.device:
        raise ValueError("nms_sorted_keep_kernel: tensors must be on one CUDA device")
    if sboxes.dtype != torch.float32 or nvalid.dtype != torch.int32:
        raise TypeError(
            f"nms_sorted_keep_kernel: expected float32 boxes and int32 counts, "
            f"got {sboxes.dtype}, {nvalid.dtype}"
        )
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4 or nvalid.shape != sboxes.shape[:1]:
        raise ValueError(
            f"nms_sorted_keep_kernel: expected (B, K, 4) and (B,), got "
            f"{tuple(sboxes.shape)}, {tuple(nvalid.shape)}"
        )
    if not (sboxes.is_contiguous() and nvalid.is_contiguous()):
        raise ValueError("nms_sorted_keep_kernel: tensors must be contiguous")
    if sboxes.data_ptr() % 16:
        raise ValueError("nms_sorted_keep_kernel: boxes must be 16-byte aligned")
    b, k = sboxes.shape[:2]
    words = (k + _TILE - 1) // _TILE
    if words > _MAX_WORDS or b > 65535:
        raise ValueError(f"nms_sorted_keep_kernel: B={b}, K={k} exceed the launch limits")
    keep = torch.empty((b, k), dtype=torch.bool, device=sboxes.device)
    if b == 0 or k == 0:
        return keep
    mask = torch.empty((b, words, k), dtype=torch.int64, device=sboxes.device)
    lib = _library()
    with torch.cuda.device(sboxes.device):
        stream = torch.cuda.current_stream(sboxes.device).cuda_stream
        err = lib.ubt_nms_keep_sorted(
            ctypes.c_void_p(sboxes.data_ptr()), ctypes.c_void_p(nvalid.data_ptr()),
            b, k, float(iou_threshold), ctypes.c_void_p(mask.data_ptr()),
            ctypes.c_void_p(keep.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    LAUNCHES["nms"] += 1
    return keep


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


@torch.library.custom_op("ubt::nms_sorted_keep", mutates_args=(), device_types="cuda")
def _nms_op(sboxes: torch.Tensor, nvalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    # contiguous here: a traced program may hand over other strides at run time
    return nms_sorted_keep_kernel(sboxes.contiguous(), nvalid.contiguous(), iou_threshold)


@_nms_op.register_kernel("cpu")
def _(sboxes, nvalid, iou_threshold):
    return nms_sorted_keep_plain(sboxes, nvalid, iou_threshold)  # by name at each call (tests patch it)


@_nms_op.register_fake
def _(sboxes, nvalid, iou_threshold):
    return sboxes.new_empty(sboxes.shape[:2], dtype=torch.bool)


def nms_sorted_keep(
    sboxes: torch.Tensor, nvalid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Keep mask (B, K) in sorted order, through the op `ubt::nms_sorted_keep`
    (traceable by torch.export): CPU tensors take the plain version; CUDA
    tensors the kernel."""
    return torch.ops.ubt.nms_sorted_keep(sboxes, nvalid, float(iou_threshold))
