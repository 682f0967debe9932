"""The one generator of every traffic mix: a seeded in-memory pool of
COCO-sized JPEGs and their dataset dicts, from a mix's parameters.

The images follow the port's loader bench (`tools/bench_loader.py`
`write_synthetic_jpegs`, copied here so that the yardstick stays put):
smooth content with solid rectangles, so decoding costs what a photograph
of that size costs (noise JPEGs are larger and slower), at the COCO
train2017 marginal sizes. Each rectangle is a ground-truth box of a class
drawn from the seed. The pool is encoded on a thread pool (cv2 releases
the interpreter lock) and kept in memory; nothing is written to disk.

A mix file (`traffic/<mix>.json`) holds, per stream ("label",
"unlabel"): `images`, the pool's size, and `boxes`, the [min, max] boxes an
image (the unlabeled stream's dicts carry none); for the whole mix `dims`
((h, w) sizes), `classes`, `jpeg_quality` and `min_box`; and the run's
parameters: `cell`, the kind of cell that drives the mix (`train` runs
harness/train_cell.py), and, which the train cell reads, `check_steps` (the
first iterations the reference follows) and `trace_steps` (the traced
iterations). The loader's threads are the configuration's
TPU.DATA_THREADS.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np


def _draw(rng: np.random.Generator, dims, boxes, classes: int, min_box: int):
    """One image's size and rectangles ((x, y, w, h, colour, class)), drawn
    from `rng`."""
    h, w = dims[int(rng.integers(len(dims)))]
    rects = []
    for _ in range(int(rng.integers(boxes[0], boxes[1] + 1))):
        bw, bh = int(rng.integers(min_box, w // 2)), int(rng.integers(min_box, h // 2))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        rects.append((x, y, bw, bh, rng.integers(0, 255, size=3), int(rng.integers(classes))))
    return h, w, rects


def _render(i: int, h: int, w: int, rects) -> np.ndarray:
    """The pixels (uint8 BGR): smooth bands, then the rectangles in order."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(128 + 100 * np.sin(xx / (20 + 10 * c) + i + c)).astype(np.uint8) for c in range(3)], axis=-1)
    for x, y, bw, bh, colour, _ in rects:
        img[y: y + bh, x: x + bw] = colour
    return img


class JpegPool:
    """file name -> (H, W, 3) uint8 BGR, decoded from the pool's bytes with
    cv2 on every call (the loaders' `image_loader`)."""

    def __init__(self):
        self.data: Dict[str, np.ndarray] = {}

    def __call__(self, file_name: str) -> np.ndarray:
        import cv2

        img = cv2.imdecode(self.data[file_name], cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(file_name)
        return img


def make_pool(mix: Dict, seed: int, threads: int = 8):
    """-> (JpegPool, {stream: dataset dicts}). Every draw comes from `seed`
    in a fixed order, whatever the thread count; the encoding runs on
    `threads` threads."""
    import cv2

    rng = np.random.default_rng([seed, 1])
    dims = [tuple(d) for d in mix["dims"]]
    specs = []  # (stream, index, h, w, rects) in draw order
    streams = ("label", "unlabel")
    for stream in streams:
        for i in range(mix[stream]["images"]):
            specs.append((stream, i) + _draw(rng, dims, mix[stream]["boxes"], mix["classes"], mix["min_box"]))
    quality = [cv2.IMWRITE_JPEG_QUALITY, int(mix["jpeg_quality"])]

    def encode(spec):
        ok, buf = cv2.imencode(".jpg", _render(*spec[1:]), quality)
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        return buf

    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        encoded = list(ex.map(encode, specs))
    pool = JpegPool()
    dicts: Dict[str, List[Dict]] = {s: [] for s in streams}
    for (stream, i, h, w, rects), buf in zip(specs, encoded):
        name = f"{stream}/{i}.jpg"
        pool.data[name] = buf
        image_id = len(pool.data)
        annos = [] if stream == "unlabel" else [
            {"bbox": [float(x), float(y), float(x + bw), float(y + bh)], "category_id": cls, "iscrowd": 0,
             "area": float(bw * bh), "id": image_id * 100 + k}
            for k, (x, y, bw, bh, _, cls) in enumerate(rects)]
        dicts[stream].append({"file_name": name, "height": h, "width": w, "image_id": image_id,
                              "annotations": annos})
    return pool, dicts
