"""Multi-level ROIAlignV2, forward and backward: the CUDA kernels
(`csrc/roi_align.cu`) and their plain PyTorch version.

Replaces ubteacher_tpu/ops/pallas/roi_align_pallas.py:
multilevel_roi_align_pallas (_fwd_kernel, _fwd_tiled_kernel, _bwd_kernel,
_bwd_tiled_kernel). What bounds it on the H100 and what the design does about
it is set out at the head of csrc/roi_align.cu.

Common arguments: `feats` are the per-level maps (B, C, H_l, W_l), float32 or
bfloat16, NCHW; `boxes` (N, 4) float32 xyxy image pixels, N = B *
rois_per_image, image-major; `level` (N,) int32, each roi's 0-based index
into `feats` (ops/roi_align.py:assign_levels); `scales` the levels' 1 /
stride. Pooled outputs are (N, P, P, C) in the feature dtype, the JAX
layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from . import build

LAUNCHES = {"roi_align_fwd": 0, "roi_align_bwd": 0}

MAX_LEVELS = 4


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
    for fn in (lib.ubt_roi_align_forward, lib.ubt_roi_align_backward):
        fn.argtypes = [i, ctypes.POINTER(_Levels), p, p, i, i, i, i, i, p, p]
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
    """Launch the forward kernel. Returns (N, P, P, C): a permuted view of
    the kernel's (N, C, P, P) output."""
    _check("roi_align_forward_kernel", feats, boxes, level, rois_per_image, scales)
    n, c, p = boxes.shape[0], feats[0].shape[1], output_size
    out = torch.empty((n, c, p, p), dtype=feats[0].dtype, device=boxes.device)
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
    return out.permute(0, 2, 3, 1)


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
    read), in the feature dtype. Accumulates in float32."""
    _check("roi_align_backward_kernel", feats, boxes, level, rois_per_image, scales)
    n, c, p = boxes.shape[0], feats[0].shape[1], output_size
    if grad.shape != (n, p, p, c) or grad.dtype != feats[0].dtype or grad.device != boxes.device:
        raise ValueError(
            f"roi_align_backward_kernel: expected a {feats[0].dtype} gradient of shape {(n, p, p, c)}, "
            f"got {grad.dtype} {tuple(grad.shape)}"
        )
    grad_ncpp = grad.permute(0, 3, 1, 2).contiguous()
    planes = [torch.zeros(f.shape, dtype=torch.float32, device=f.device) for f in feats]
    if n and c:
        lv = _levels(planes, scales)
        lib = _library()
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream(boxes.device).cuda_stream
            err = lib.ubt_roi_align_backward(
                int(grad.dtype == torch.bfloat16), ctypes.byref(lv), boxes.data_ptr(),
                level.data_ptr(), n, rois_per_image, c, p, sampling_ratio, grad_ncpp.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"roi_align backward kernel launch failed: CUDA error {err}")
        LAUNCHES["roi_align_bwd"] += 1
    return [g.to(f.dtype) for g, f in zip(planes, feats)]


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
    the feature dtype."""
    n = boxes.shape[0]
    c, p = feats[0].shape[1], output_size
    img = torch.arange(n, device=boxes.device) // rois_per_image
    pooled, order = [], []
    for lv, (f, scale) in enumerate(zip(feats, scales)):
        hwc = f.permute(0, 2, 3, 1)
        sel_all = torch.nonzero(level == lv)[:, 0]
        for start in range(0, sel_all.numel(), roi_chunk):
            sel = sel_all[start:start + roi_chunk]
            pooled.append(_pool_chunk(hwc, img[sel], boxes[sel], scale, p, sampling_ratio).to(f.dtype))
            order.append(sel)
    if not pooled:
        return feats[0].new_zeros((n, p, p, c))
    return torch.cat(pooled)[torch.argsort(torch.cat(order))]
