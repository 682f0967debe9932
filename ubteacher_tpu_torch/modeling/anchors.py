"""Anchor generation, detectron2 DefaultAnchorGenerator semantics (PyTorch
port of ubteacher_tpu.modeling.anchors).

Anchors depend only on the canvas and the configuration, so they are built
once per canvas with numpy and cached; each call hands out tensors on the
requested device. Order: level by level, grid-major (row-major over the
feature map) with the cell anchor innermost, the order of the RPN head's
(B, H*W, A) outputs.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """Base anchors centred at (0, 0), (len(sizes) * len(ratios), 4) xyxy:
    area = size^2, w = sqrt(area / ratio), h = ratio * w."""
    out = []
    for size in sizes:
        area = size**2
        for ratio in aspect_ratios:
            w = math.sqrt(area / ratio)
            h = ratio * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float64)


@functools.lru_cache(maxsize=16)
def _anchors_numpy(canvas_hw: Tuple[int, int], strides: Tuple[int, ...],
                   sizes: Tuple[Tuple[float, ...], ...], aspect_ratios: Tuple[Tuple[float, ...], ...],
                   offset: float):
    h, w = canvas_hw
    n_lvl = len(strides)
    if len(sizes) == 1:
        sizes = sizes * n_lvl
    if len(aspect_ratios) == 1:
        aspect_ratios = aspect_ratios * n_lvl
    all_anchors: List[np.ndarray] = []
    lengths: List[int] = []
    lids: List[np.ndarray] = []
    origins: List[np.ndarray] = []
    for lvl, stride in enumerate(strides):
        fh, fw = -(-h // stride), -(-w // stride)
        base = cell_anchors(sizes[lvl], aspect_ratios[lvl])
        sx = (np.arange(fw) + offset) * stride
        sy = (np.arange(fh) + offset) * stride
        gx, gy = np.meshgrid(sx, sy)
        shifts = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()], axis=1)
        anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
        ox, oy = np.meshgrid(np.arange(fw) * stride, np.arange(fh) * stride)
        cell_org = np.stack([ox.ravel(), oy.ravel()], axis=1)
        origins.append(np.repeat(cell_org, base.shape[0], axis=0))
        all_anchors.append(anchors)
        lengths.append(anchors.shape[0])
        lids.append(np.full(anchors.shape[0], lvl, np.int32))
    return (
        np.concatenate(all_anchors).astype(np.float32),
        lengths,
        np.concatenate(lids),
        np.concatenate(origins).astype(np.float32),
    )


def generate_anchors(
    canvas_hw: Tuple[int, int],
    strides: Sequence[int],
    sizes: Sequence[Sequence[float]],
    aspect_ratios: Sequence[Sequence[float]],
    offset: float = 0.0,
    device: torch.device | str = "cuda",
) -> Dict[str, object]:
    """All-level anchors of a canvas: {"anchors": (A, 4) f32,
    "level_lengths": [anchors per level], "level_ids": (A,) int32,
    "cell_origins": (A, 2) f32, the (x, y) canvas origin of each anchor's
    feature-map cell}. A single sizes/aspect_ratios entry is shared by all
    levels, as in detectron2."""
    anchors, lengths, lids, origins = _anchors_numpy(
        (int(canvas_hw[0]), int(canvas_hw[1])), tuple(int(s) for s in strides),
        tuple(tuple(float(v) for v in s) for s in sizes),
        tuple(tuple(float(v) for v in a) for a in aspect_ratios), float(offset),
    )
    # non_blocking: a blocking copy from pageable memory waits for the
    # device; the cached arrays outlive the copy
    return {
        "anchors": torch.from_numpy(anchors).to(device, non_blocking=True),
        "level_lengths": list(lengths),
        "level_ids": torch.from_numpy(lids).to(device, non_blocking=True),
        "cell_origins": torch.from_numpy(origins).to(device, non_blocking=True),
    }
