"""Test loader (PyTorch port of ubteacher_tpu.data.loader.TestDataLoader).

Deterministic order, resize to the MIN_SIZE_TEST shortest edge (capped by
MAX_SIZE_TEST and by the canvas), no flip, zero-padded to a fixed test
canvas, batches grouped by orientation so portrait images get the transposed
canvas (reference: build_detection_test_loader, build.py:114-142). Batches
are CPU tensors, assembled in numpy buffers by a thread pool (so iterating
under torch.inference_mode is fine); the evaluator moves them to the model's
device.

The resize (`resize_bilinear`) is a numpy replica of
cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR) on uint8 images,
bitwise, as the JAX loader calls it; cv2 is imported only by the default
image reader.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def default_image_loader(file_name: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR from an image file, read with cv2."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading image files needs cv2 (opencv-python); pass an image_loader to TestDataLoader instead"
        ) from e
    img = cv2.imread(file_name, cv2.IMREAD_COLOR)  # BGR
    if img is None:
        raise FileNotFoundError(file_name)
    return img


def _linear_taps(dst: int, src: int):
    """cv2's source index and fraction per output position: the centre
    (d + 0.5) * (1 / (dst / src)) - 0.5 in float64, rounded to float32,
    floored."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _fixed_point(frac: np.ndarray):
    """The two 11-bit weights (1 - f, f) * 2048, each rounded to nearest even
    from float32 (cv2's saturate_cast<short>)."""
    one, scale = np.float32(1), np.float32(2048)
    return np.rint((one - frac) * scale).astype(np.int32), np.rint(frac * scale).astype(np.int32)


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(H, W, C) uint8 -> (nh, nw, C) uint8, bitwise equal to
    cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR) (OpenCV's
    fixed-point path for 8-bit images), without cv2.

    The arithmetic is cv2's: an exact 2x downscale of both sides is its
    2x2 area mean ((a + b + c + d + 2) >> 2); an unchanged size is a copy.
    Otherwise the horizontal pass sums two taps with 11-bit weights into an
    int (a tap left of the image takes the first column with weight 2048, one
    right of it the last), and the vertical pass, cv2's vector one, takes
    ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2 over the
    two source rows, clamped to the image, and saturates to uint8. The
    vertical fractions are not clamped at the borders; the clamped rows
    repeat instead."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bilinear: expected (H, W, C) uint8, got {img.dtype} {img.shape}")
    h, w, cn = img.shape
    if nh < 1 or nw < 1:
        raise ValueError(f"resize_bilinear: output size ({nh}, {nw}) is empty")
    if (nh, nw) == (h, w):
        return img.copy()
    if (h, w) == (2 * nh, 2 * nw):
        a = img.astype(np.int32)
        return ((a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    sx, fx = _linear_taps(nw, w)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _fixed_point(fx)
    px = img.astype(np.int32)  # sums stay below 2**27
    rows = px[:, sx] * a0[:, None] + px[:, np.minimum(sx + 1, w - 1)] * a1[:, None]  # (h, nw, cn)
    sy, fy = _linear_taps(nh, h)
    b0, b1 = _fixed_point(fy)
    s0 = rows[np.clip(sy, 0, h - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    out = (((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


class TestDataLoader:
    """Eval loader. Each batch: images (B, ch, cw, 3) float32 BGR, hw (B, 2)
    the resized size in the canvas, scales (B,) resized / original,
    image_ids, num_valid (rows past it are zero padding)."""

    def __init__(self, cfg, dataset_dicts: List[Dict], batch_size: int = 1,
                 image_loader: Optional[Callable[[str], np.ndarray]] = None):
        self.cfg = cfg
        self.dicts = dataset_dicts
        self.batch_size = batch_size
        ch, cw = cfg.TPU.TEST_CANVAS
        self.canvas = {
            "landscape": (min(ch, cw), max(ch, cw)),
            "portrait": (max(ch, cw), min(ch, cw)),
        }
        self.min_size = cfg.INPUT.MIN_SIZE_TEST
        self.max_size = cfg.INPUT.MAX_SIZE_TEST
        self.num_threads = cfg.TPU.DATA_THREADS
        self._pool_obj: Optional[ThreadPoolExecutor] = None
        self._image_loader = image_loader or default_image_loader
        self._groups = {"landscape": [], "portrait": []}
        for d in dataset_dicts:
            orient = (
                "landscape" if d.get("width", 1) >= d.get("height", 0)
                else "portrait"
            )
            self._groups[orient].append(d)

    def __len__(self):
        return sum(
            -(-len(g) // self.batch_size) for g in self._groups.values() if g
        )

    def _emit(self, chunk: List[Dict], canvas):
        ch, cw = canvas
        images = np.zeros((self.batch_size, ch, cw, 3), np.float32)
        hw = np.zeros((self.batch_size, 2), np.float32)
        scales = np.ones((self.batch_size,), np.float32)

        def load_one(i_d):
            # decode + resize in a pool thread; each row writes a disjoint
            # slice of the shared arrays
            i, d = i_d
            img = self._image_loader(d["file_name"])
            h, w = img.shape[:2]
            scale = self.min_size / min(h, w)
            if max(h, w) * scale > self.max_size:
                scale = self.max_size / max(h, w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            if nh > ch or nw > cw:
                s2 = min(ch / nh, cw / nw)
                nh, nw = int(nh * s2), int(nw * s2)
                scale = scale * s2
            images[i, :nh, :nw] = resize_bilinear(img, nh, nw)
            hw[i] = (nh, nw)
            scales[i] = scale

        if self.num_threads > 0 and len(chunk) > 1:
            if self._pool_obj is None:
                self._pool_obj = ThreadPoolExecutor(
                    max_workers=max(1, self.num_threads),
                    thread_name_prefix="ubt-eval-decode",
                )
            list(self._pool_obj.map(load_one, enumerate(chunk)))
        else:
            for i_d in enumerate(chunk):
                load_one(i_d)
        return {
            "images": torch.from_numpy(images),
            "hw": torch.from_numpy(hw),
            "scales": torch.from_numpy(scales),
            "image_ids": [d["image_id"] for d in chunk],
            "num_valid": len(chunk),
        }

    def __iter__(self):
        for orient, dicts in self._groups.items():
            canvas = self.canvas[orient]
            for start in range(0, len(dicts), self.batch_size):
                yield self._emit(dicts[start : start + self.batch_size], canvas)
