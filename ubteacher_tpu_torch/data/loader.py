"""Test loader (PyTorch port of ubteacher_tpu.data.loader.TestDataLoader).

Deterministic order, resize to the MIN_SIZE_TEST shortest edge (capped by
MAX_SIZE_TEST and by the canvas), no flip, zero-padded to a fixed test
canvas, batches grouped by orientation so portrait images get the transposed
canvas (reference: build_detection_test_loader, build.py:114-142). Batches
are CPU tensors, assembled in numpy buffers by a thread pool (so iterating
under torch.inference_mode is fine); the evaluator moves them to the model's
device.

The resize is torch's bilinear interpolation (align_corners=False, no
antialiasing), the sampling of cv2.INTER_LINEAR, computed in float32; cv2
is imported only by the default image reader.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


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


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> torch.Tensor:
    """(H, W, 3) image -> (nh, nw, 3) float32, cv2.INTER_LINEAR's sampling."""
    x = torch.from_numpy(np.ascontiguousarray(img)).float().permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0)


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
            images[i, :nh, :nw] = resize_bilinear(img, nh, nw).numpy()
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
