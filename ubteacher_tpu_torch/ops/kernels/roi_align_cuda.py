"""Multi-level ROIAlignV2, forward and backward: the CUDA kernels
(`csrc/roi_align.cu`) and their plain PyTorch version.

Replaces ubteacher_tpu/ops/pallas/roi_align_pallas.py:
multilevel_roi_align_pallas (_fwd_kernel, _fwd_tiled_kernel, _bwd_kernel,
_bwd_tiled_kernel).

Both directions are bound on the H100 by the bytes they must move (the
feature pixels the rois read and the pooled output; the pooled gradient in
and every level's gradient out), and both spend their time on instruction
issue and latency instead, so both are built around per-roi work done once
and shared: the same taps (make_axis / sample_tap) and separable bin weights.
The forward runs one block per (roi, 256 channels): the roi's taps and bin
weights are computed once into shared memory, its footprint is staged there
64 channels at a time with cp.async from the NCHW planes, contracted with
the weights in float32 registers, and written contiguous in the JAX layout
(N, P, P, C), so the box head's reshape is a view; it needs no host-side
preparation. The backward owns each (image, level, 16 x 32 tile, 32
channels) of the gradient with one block, which walks that image's rois on
that level and writes the tile once, in the feature dtype, with no atomics.
The wrapper prepares that walk in plain torch on the device, with no host
sync: `group_rois` sorts the rois stably by (image, level) into segments,
and `roi_footprints` gives each roi the pixel rectangle its samples touch,
so a block skips the rois that miss its tile. The head of csrc/roi_align.cu
sets both designs out.

Common arguments: `feats` are the per-level maps (B, C, H_l, W_l), float32 or
bfloat16, NCHW; `boxes` (N, 4) float32 xyxy image pixels, N = B *
rois_per_image, image-major; `level` (N,) int32, each roi's 0-based index
into `feats` (ops/roi_align.py:assign_levels); `scales` the levels' 1 /
stride. Pooled outputs are (N, P, P, C) in the feature dtype, the JAX
layout.

The forward kernel is the CUDA implementation of the torch.library op
`ubt::roi_align_forward`, whose CPU implementation is the plain version and
whose shape function lets torch.export trace it. The backward kernel runs
only under autograd (ops/roi_align.py), where no trace needs it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from . import build

LAUNCHES = {"roi_align_fwd": 0, "roi_align_bwd": 0}

MAX_LEVELS = 4
MAX_POOLED = 16  # kMaxPooled of the kernels


class _Levels(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p * MAX_LEVELS),
        ("height", ctypes.c_int * MAX_LEVELS),
        ("width", ctypes.c_int * MAX_LEVELS),
        ("scale", ctypes.c_float * MAX_LEVELS),
        ("count", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build.build("roi_align"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ubt_roi_align_forward.argtypes = [i, ctypes.POINTER(_Levels), p, p, i, i, i, i, i, p, p]
    lib.ubt_roi_align_backward.argtypes = [i, ctypes.POINTER(_Levels), p, p, p, p, i, i, i, i, p, p]
    for fn in (lib.ubt_roi_align_forward, lib.ubt_roi_align_backward):
        fn.restype = ctypes.c_int
    return lib


def _levels(planes: Sequence[torch.Tensor], scales: Sequence[float]) -> _Levels:
    lv = _Levels()
    for k, (t, s) in enumerate(zip(planes, scales)):
        lv.data[k] = t.data_ptr()
        lv.height[k] = t.shape[2]
        lv.width[k] = t.shape[3]
        lv.scale[k] = s
    lv.count = len(planes)
    return lv


def _check(name: str, feats, boxes, level, rois_per_image, scales) -> None:
    if not feats or len(feats) > MAX_LEVELS or len(scales) != len(feats):
        raise ValueError(f"{name}: 1 to {MAX_LEVELS} levels with one scale each, got {len(feats)}")
    dev = boxes.device
    if not boxes.is_cuda or level.device != dev or any(f.device != dev for f in feats):
        raise ValueError(f"{name}: tensors must be on one CUDA device")
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(f.dtype != dtype for f in feats):
        raise TypeError(f"{name}: features must all be float32 or all bfloat16, got {[f.dtype for f in feats]}")
    if boxes.dtype != torch.float32 or level.dtype != torch.int32:
        raise TypeError(f"{name}: expected float32 boxes and int32 levels, got {boxes.dtype}, {level.dtype}")
    b, c = feats[0].shape[:2]
    if any(f.dim() != 4 or f.shape[:2] != (b, c) for f in feats):
        raise ValueError(f"{name}: levels must share (B, C), got {[tuple(f.shape) for f in feats]}")
    n = boxes.shape[0]
    if boxes.dim() != 2 or boxes.shape[1] != 4 or level.shape != (n,) or n != b * rois_per_image:
        raise ValueError(
            f"{name}: expected boxes ({b * rois_per_image}, 4) and levels ({b * rois_per_image},), got "
            f"{tuple(boxes.shape)}, {tuple(level.shape)}"
        )
    if not (boxes.is_contiguous() and level.is_contiguous() and all(f.is_contiguous() for f in feats)):
        raise ValueError(f"{name}: tensors must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError(f"{name}: boxes must be 16-byte aligned")


def roi_align_forward_kernel(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    level: torch.Tensor,
    rois_per_image: int,
    scales: Sequence[float],
    output_size: int,
    sampling_ratio: int,
) -> torch.Tensor:
    """Launch the forward kernel. Returns (N, P, P, C), contiguous, in the
    feature dtype; a roi whose level lies outside [0, len(feats)) gets NaN."""
    _check("roi_align_forward_kernel", feats, boxes, level, rois_per_image, scales)
    n, c, p = boxes.shape[0], feats[0].shape[1], output_size
    if not 1 <= p <= MAX_POOLED or sampling_ratio < 0:
        raise ValueError(
            f"roi_align_forward_kernel: output_size must lie in [1, {MAX_POOLED}] and sampling_ratio be >= 0, "
            f"got {p}, {sampling_ratio}"
        )
    out = torch.empty((n, p, p, c), dtype=feats[0].dtype, device=boxes.device)
    if n and c:
        lv = _levels(feats, scales)
        lib = _library()
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream(boxes.device).cuda_stream
            err = lib.ubt_roi_align_forward(
                int(feats[0].dtype == torch.bfloat16), ctypes.byref(lv), boxes.data_ptr(),
                level.data_ptr(), n, rois_per_image, c, p, sampling_ratio, out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"roi_align forward kernel launch failed: CUDA error {err}")
        LAUNCHES["roi_align_fwd"] += 1
    return out


def group_rois(level: torch.Tensor, batch: int, rois_per_image: int, count: int):
    """Group the rois by (image, level) for the backward kernel. -> order
    (N,) int64, the roi indices sorted stably by image * count + level, rois
    whose level lies outside [0, count) last; seg (batch * count + 1,) int32,
    where segment s = image * count + level holds order[seg[s]:seg[s + 1]].
    Plain torch on the rois' device, with no host sync (torch.bincount reads
    its largest entry back to the host, so the offsets are a searchsorted of
    the sorted keys)."""
    dev = level.device
    segments = batch * count
    img = torch.arange(level.shape[0], device=dev).div_(max(rois_per_image, 1), rounding_mode="floor")
    lv = level.long()
    key = torch.where((lv >= 0) & (lv < count), img * count + lv, segments)
    sorted_key, order = torch.sort(key, stable=True)
    seg = torch.searchsorted(sorted_key, torch.arange(segments + 1, device=dev), out_int32=True)
    return order, seg


def roi_footprints(
    boxes: torch.Tensor,
    level: torch.Tensor,
    scales: Sequence[float],
    shapes: Sequence[Sequence[int]],
    output_size: int,
    sampling_ratio: int,
) -> torch.Tensor:
    """(N, 4) int32 [y_lo, y_hi, x_lo, x_hi]: the pixels of its level that a
    roi's bilinear samples touch, widened by one pixel on each side so that a
    rounding difference between torch and the kernel at a pixel boundary
    cannot drop gradient. The samples are those of ops/roi_align.py:
    sample_coords, clipped into the map as the forward clips them, and touch
    lo = floor(pos) and hi = min(lo + 1, H - 1); the first sample of the
    first bin and the last of the last bound them. A roi with a non-finite
    box or a level outside [0, len(scales)) gets the empty rectangle
    [0, -1] x [0, -1]. `shapes` are the levels' (H, W)."""
    from ..roi_align import ADAPTIVE_MAX_S

    dev = boxes.device
    valid = (level >= 0) & (level < len(scales)) & torch.isfinite(boxes).all(1)
    # a non-blocking copy: torch.tensor(..., device=) and indexing with a
    # list wait for the device
    table = torch.tensor([[s, h, w] for s, (h, w) in zip(scales, shapes)], dtype=torch.float32)
    table = table.to(dev, non_blocking=True)[torch.where(valid, level, 0).long()]
    scale, last_px = table[:, :1], table[:, 1:] - 1  # (N, 1); (N, 2) as (y, x)
    # as sample_coords: y1, x1, y2, x2 on the level, shifted half a pixel;
    # every division by a tensor (see bin_sample_positions)
    corners = torch.where(valid[:, None], boxes, 0.0).view(-1, 2, 2).flip(-1).reshape(-1, 4) * scale - 0.5
    start = corners[:, :2]
    bin_size = torch.clamp(corners[:, 2:] - start, min=1e-6)
    bin_size = bin_size / torch.full_like(bin_size, float(output_size))
    if sampling_ratio > 0:
        s = torch.full_like(bin_size, float(sampling_ratio))
    else:
        s = torch.clamp(torch.ceil(bin_size), 1.0, float(ADAPTIVE_MAX_S))
    # sample i of bin p sits at start + (p + (i + 0.5) / s) * bin; first:
    # p = i = 0, last: p = P - 1, i = s - 1
    frac = torch.stack([torch.full_like(s, 0.5), s - 0.5], -1) / s[..., None]
    frac[..., 1] += output_size - 1
    pos = start[..., None] + frac * bin_size[..., None]
    pos = torch.floor(torch.minimum(pos.clamp_min(0.0), last_px[..., None]))
    lo = torch.where(valid[:, None], (pos[..., 0] - 1).clamp_min(0.0), 0.0)
    hi = torch.where(valid[:, None], torch.minimum(pos[..., 1] + 2, last_px), -1.0)
    return torch.stack([lo, hi], -1).reshape(-1, 4).to(torch.int32)


def roi_align_backward_kernel(
    grad: torch.Tensor,
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    level: torch.Tensor,
    rois_per_image: int,
    scales: Sequence[float],
    output_size: int,
    sampling_ratio: int,
) -> List[torch.Tensor]:
    """Launch the backward kernel: grad (N, P, P, C) of the pooled output ->
    the gradient of each level of `feats` (only their shapes and dtype are
    read), in the feature dtype and layout (NCHW, contiguous), each element
    written once by the kernel. Accumulates in float32; bitwise the same
    from run to run."""
    _check("roi_align_backward_kernel", feats, boxes, level, rois_per_image, scales)
    n, c, p = boxes.shape[0], feats[0].shape[1], output_size
    if grad.shape != (n, p, p, c) or grad.dtype != feats[0].dtype or grad.device != boxes.device:
        raise ValueError(
            f"roi_align_backward_kernel: expected a {feats[0].dtype} gradient of shape {(n, p, p, c)}, "
            f"got {grad.dtype} {tuple(grad.shape)}"
        )
    if not 1 <= p <= MAX_POOLED:
        raise ValueError(f"roi_align_backward_kernel: output_size must lie in [1, {MAX_POOLED}], got {p}")
    grad = grad.contiguous()  # autograd hands the gradient over contiguous: no copy then
    out = [torch.empty_like(f) for f in feats]
    if c and any(f.numel() for f in feats):
        order, seg = group_rois(level, feats[0].shape[0], rois_per_image, len(feats))
        foot = roi_footprints(boxes, level, scales, [f.shape[2:] for f in feats], p, sampling_ratio)[order]
        lv = _levels(out, scales)
        lib = _library()
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream(boxes.device).cuda_stream
            err = lib.ubt_roi_align_backward(
                int(grad.dtype == torch.bfloat16), ctypes.byref(lv), boxes.data_ptr(), order.data_ptr(),
                seg.data_ptr(), foot.data_ptr(), feats[0].shape[0], c, p, sampling_ratio, grad.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"roi_align backward kernel launch failed: CUDA error {err}")
        LAUNCHES["roi_align_bwd"] += 1
    return out


def _pool_chunk(feat_hwc, img, boxes, scale, output_size, sampling_ratio):
    """4-corner bilinear gather of the rois `boxes` (r, 4) of images `img`
    (r,) on one level (B, H, W, C): ops/roi_align.py's gather formulation
    (the JAX package's `roi_align`), summed in float32. -> (r, P, P, C)."""
    from ..roi_align import sample_coords

    h, w = feat_hwc.shape[1:3]
    ys, cy, xs, cx = sample_coords(boxes, scale, output_size, sampling_ratio)  # (r, P, S)
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    yy = ys[:, :, :, None, None].expand(-1, -1, -1, xs.shape[1], xs.shape[2])
    xx = xs[:, None, None, :, :].expand_as(yy)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    y1i = torch.clamp(y0 + 1, max=h - 1).long()
    x1i = torch.clamp(x0 + 1, max=w - 1).long()
    y0i, x0i = y0.long(), x0.long()
    wy1 = yy - y0
    wx1 = xx - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    bi = img[:, None, None, None, None].expand_as(y0i)

    def corner(yi, xi):
        return feat_hwc[bi, yi, xi].float()  # (r, P, S, P, S, C)

    vals = (
        corner(y0i, x0i) * (wy0 * wx0)[..., None]
        + corner(y0i, x1i) * (wy0 * wx1)[..., None]
        + corner(y1i, x0i) * (wy1 * wx0)[..., None]
        + corner(y1i, x1i) * (wy1 * wx1)[..., None]
    )
    wgt = cy[:, :, :, None, None] * cx[:, None, None, :, :]
    return (vals * wgt[..., None]).sum(dim=(2, 4))


def roi_align_plain(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    level: torch.Tensor,
    rois_per_image: int,
    scales: Sequence[float],
    output_size: int,
    sampling_ratio: int,
    roi_chunk: int = 64,
) -> torch.Tensor:
    """Plain version, one level and `roi_chunk` rois at a time (the full
    sample grid of every roi on every level would not fit at p2 x 24
    images). Differentiable in `feats` through autograd. -> (N, P, P, C) in
    the feature dtype; a roi whose level lies outside [0, len(feats)) gets
    NaN, as in the kernel."""
    n = boxes.shape[0]
    c, p = feats[0].shape[1], output_size
    img = torch.arange(n, device=boxes.device) // rois_per_image
    out = feats[0].new_full((n, p, p, c), float("nan"))
    for lv, (f, scale) in enumerate(zip(feats, scales)):
        hwc = f.permute(0, 2, 3, 1)
        sel_all = torch.nonzero(level == lv)[:, 0]
        for start in range(0, sel_all.numel(), roi_chunk):
            sel = sel_all[start:start + roi_chunk]
            out[sel] = _pool_chunk(hwc, img[sel], boxes[sel], scale, p, sampling_ratio).to(f.dtype)
    return out


@torch.library.custom_op("ubt::roi_align_forward", mutates_args=(), device_types="cuda")
def roi_align_forward(feats: List[torch.Tensor], boxes: torch.Tensor, level: torch.Tensor, rois_per_image: int,
                      scales: List[float], output_size: int, sampling_ratio: int) -> torch.Tensor:
    """The op of the forward: `roi_align_forward_kernel` on CUDA tensors
    (made contiguous here: a traced program may hand over the strides its
    convolutions chose at run time), `roi_align_plain` on CPU tensors."""
    return roi_align_forward_kernel([f.contiguous() for f in feats], boxes.contiguous(), level.contiguous(),
                                    rois_per_image, scales, output_size, sampling_ratio)


@roi_align_forward.register_kernel("cpu")
def _(feats, boxes, level, rois_per_image, scales, output_size, sampling_ratio):
    return roi_align_plain(feats, boxes, level, rois_per_image, scales, output_size, sampling_ratio)


@roi_align_forward.register_fake
def _(feats, boxes, level, rois_per_image, scales, output_size, sampling_ratio):
    return boxes.new_empty((boxes.shape[0], output_size, output_size, feats[0].shape[1]), dtype=feats[0].dtype)
