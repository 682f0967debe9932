"""Two-stream train loader and test loader (PyTorch port of
ubteacher_tpu.data.loader).

TwoStreamDataLoader is the host side of the reference's
build_detection_semisup_train_loader_two_crops +
AspectRatioGroupedSemiSupDatasetTwoCrop (ubteacher/data/build.py:144-272,
data/common.py:93-167), for fixed shapes:

  * only the weak view is made on the host (resize jitter, flip, optional
    crop, pad to a canvas); the strong view is made on the device inside the
    train step, so a step ships two image batches, as uint8;
  * batches are grouped by orientation and by the chosen canvas (the base
    canvas of each orientation plus TPU.EXTRA_TRAIN_CANVASES), so every
    batch has one fixed shape;
  * ground truth is padded to (B, MAX_GT) PaddedInstances of numpy arrays;
  * geometry is drawn in order from the dataset's metadata, pixels are
    materialized on a thread pool, and batches are assembled by a prefetch
    thread into a queue.

Batches are numpy (images uint8 BGR), as the JAX loader's are; the trainer
copies them to the card from pinned memory.

TestDataLoader: deterministic order, resize to the MIN_SIZE_TEST shortest
edge (capped by MAX_SIZE_TEST and by the canvas), no flip, zero-padded to a
fixed test canvas, batches grouped by orientation so portrait images get the
transposed canvas (reference: build_detection_test_loader, build.py:114-142).
Its batches are CPU tensors, assembled in numpy buffers by a thread pool (so
iterating under torch.inference_mode is fine); the evaluator moves them to
the model's device.

The resize (`resize_bilinear`) is a numpy replica of
cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR) on uint8 images,
bitwise, as the JAX loaders call it; cv2 is imported only by the default
image reader.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..parallel import owned_rows, rank, world_size
from ..structures import PaddedInstances
from ..utils.events import span
from .augment import materialize_weak_augment, weak_augment_geometry

logger = logging.getLogger("ubteacher_tpu_torch")

# image decodes per stream, and "corrupt": samples that failed to load and
# were replaced (one process: by the next drawn sample; several: by a zero
# image and gt row); the trainer reports the corrupt count every iteration
# as corrupt_rows_total (the reference re-draws silently,
# data/common.py:22-43)
DECODE_STATS = {"train": 0, "test": 0, "corrupt": 0}
_STATS_LOCK = threading.Lock()
# batches ready in the prefetch queue when the consumer last asked for one
# (the trainer reports it every iteration as loader_queue_depth)
PREFETCH = {"ready": 0}

# TPU.ORACLE_PSEUDO: the boundary-uncertainty logit attached to oracle boxes
# (ground truth fed as pseudo labels). The tsbetter gates read the teacher's
# loc-confidence as 1 - sigmoid(std): -6.0 gives 0.9975, above every shipped
# T_CERT / TS_BETTER_CERT, so the oracle set passes the gate wherever the
# student is less certain.
ORACLE_BOX_STD = -6.0


def _bump(key: str, n: int = 1) -> None:
    """Thread-safe DECODE_STATS increment: decodes run on a pool."""
    with _STATS_LOCK:
        DECODE_STATS[key] += n


def default_image_loader(file_name: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR from an image file, read with cv2."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading image files needs cv2 (opencv-python); pass an image_loader to the data loader instead"
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


def _pad_gt(objs: List[Dict], max_gt: int) -> Dict[str, np.ndarray]:
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    n = min(len(objs), max_gt)
    for i in range(n):
        boxes[i] = objs[i]["bbox"]
        classes[i] = objs[i]["category_id"]
        mask[i] = True
    return {"boxes": boxes, "classes": classes, "mask": mask}


class _InfiniteSampler:
    """Infinite shuffled index stream (reference: D2 TrainingSampler)."""

    def __init__(self, n: int, seed: int):
        self._n = n
        self._rng = np.random.default_rng(seed)
        self._perm: List[int] = []

    def __next__(self) -> int:
        if not self._perm:
            self._perm = list(self._rng.permutation(self._n))
        return self._perm.pop()


class TwoStreamDataLoader:
    """Yields fixed-shape semi-supervised batches:

      images_label_k   (B, H, W, 3) uint8 BGR weak view
      gt_label         PaddedInstances (B, MAX_GT, ...) of numpy arrays
      label_hw         (B, 2) float32 true (h, w) inside the canvas
      images_unlabel_k (Bu, Hu, Wu, 3) uint8
      unlabel_hw       (Bu, 2)
      gt_unlabel       (TPU.ORACLE_PSEUDO only) the unlabeled stream's gt,
                       score 1 and box_std ORACLE_BOX_STD

    Batches are equal, byte for byte, to the JAX loader's for the same seed
    and images, and so are the rows of process `process_index` of
    `process_count` (default: this rank of the process group). With several
    processes every one replays the same sample selection and geometry
    draws from the metadata alone, and reads and augments only the global
    batch rows it owns (parallel.owned_rows; a batch size they do not divide
    raises); a corrupt owned file becomes a zero image with an empty gt row,
    never a redraw, which would put the processes' streams out of step.
    """

    def __init__(
        self,
        cfg,
        label_dicts: List[Dict],
        unlabel_dicts: List[Dict],
        seed: int = 0,
        image_loader: Optional[Callable[[str], np.ndarray]] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        if process_count is None:
            process_count, process_index = world_size(), rank()
        self.process_count = process_count
        self.process_index = process_index or 0
        self.local_rows = process_count > 1
        if self.local_rows:
            for b in (cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.IMG_PER_BATCH_UNLABEL):
                owned_rows(b, self.process_index, process_count)  # raises unless divisible
        self.cfg = cfg
        # D2 filter_images_with_only_crowd_annotations: an image counts as
        # empty unless it has at least one non-crowd annotation
        self.label_dicts = [
            d for d in label_dicts
            if not cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
            or any(o.get("iscrowd", 0) == 0 for o in d["annotations"])
        ]
        self.unlabel_dicts = unlabel_dicts
        self.batch_label = cfg.SOLVER.IMG_PER_BATCH_LABEL
        self.batch_unlabel = cfg.SOLVER.IMG_PER_BATCH_UNLABEL
        self.max_gt = cfg.TPU.MAX_GT
        # per-orientation canvas candidates (scale buckets): the base canvas
        # plus the TPU.EXTRA_TRAIN_CANVASES of that orientation; batches are
        # bucketed per chosen canvas
        self.canvases = {
            "landscape": [tuple(cfg.TPU.CANVAS_LANDSCAPE)],
            "portrait": [tuple(cfg.TPU.CANVAS_PORTRAIT)],
        }
        for c in cfg.TPU.EXTRA_TRAIN_CANVASES:
            h, w = int(c[0]), int(c[1])
            self.canvases["landscape" if w >= h else "portrait"].append((h, w))
        self.min_size = cfg.INPUT.MIN_SIZE_TRAIN
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN
        self.sampling = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
        # INPUT.CROP (reference: dataset_mapper.py:38-44)
        self.crop = (
            (cfg.INPUT.CROP.TYPE, tuple(cfg.INPUT.CROP.SIZE))
            if cfg.INPUT.CROP.ENABLED else None
        )
        self.seed = seed
        self.num_threads = cfg.TPU.DATA_THREADS
        self.oracle = cfg.TPU.ORACLE_PSEUDO
        self._image_loader = image_loader or default_image_loader
        self._pool_obj: Optional[ThreadPoolExecutor] = None

    def _prepare_geom(self, d: Dict, rng: np.random.Generator) -> Dict:
        """One sample's geometry: the rng draws and box math from the dict's
        width and height alone, no image read. Crowd annotations never become
        training targets (the reference drops iscrowd != 0 in the mapper,
        dataset_mapper.py:129); eval reads the dataset dicts directly."""
        h, w = int(d["height"]), int(d["width"])
        orient = "landscape" if w >= h else "portrait"
        annos = [o for o in d["annotations"] if o.get("iscrowd", 0) == 0]
        boxes = np.asarray([o["bbox"] for o in annos], np.float32).reshape(-1, 4)
        geom = weak_augment_geometry(
            h, w, boxes, self.canvases[orient], self.min_size, self.max_size,
            self.sampling, rng, crop=self.crop,
        )
        objs = [
            {"bbox": geom["boxes"][i], "category_id": o["category_id"]}
            for i, o in enumerate(annos)
            if geom["keep"][i]
        ]
        return {
            "dict": d,
            "geom": geom,
            "hw": geom["hw"],
            "gt": _pad_gt(objs, self.max_gt),
            "bucket": geom["canvas"],
        }

    def _stream(self, dicts: List[Dict], seed: int) -> Iterator[Dict]:
        """Infinite stream of geometry records (no image read). A sample
        whose metadata fails is replaced by the next index, at most 3 in a
        row (the reference's MapDatasetTwoCrop retry, data/common.py:22-43)."""
        sampler = _InfiniteSampler(len(dicts), seed)
        rng = np.random.default_rng(seed + 12345)
        warned = 0
        while True:
            for _ in range(3):
                d = dicts[next(sampler)]
                try:
                    yield self._prepare_geom(d, rng)
                    break
                except Exception:  # bad metadata: draw another sample
                    _bump("corrupt")
                    if warned < 5:
                        logger.warning("failed to load %s; retrying with another sample", d.get("file_name", "?"))
                        warned += 1
            else:
                raise RuntimeError("3 consecutive corrupt samples")

    @staticmethod
    def _batched_stream(items: Iterator[Dict], batch_size: int) -> Iterator[List[Dict]]:
        """One bucket per chosen canvas (orientation and scale): a batch is
        emitted when its bucket fills (the reference groups by aspect only,
        common.py:93-167, and pads each batch to its largest image)."""
        buckets: Dict[tuple, List[Dict]] = {}
        for item in items:
            b = buckets.setdefault(item["bucket"], [])
            b.append(item)
            if len(b) == batch_size:
                yield b[:]
                b.clear()

    @property
    def _pool(self) -> ThreadPoolExecutor:
        """The shared materialize pool, made at first use (numpy's resize
        releases the interpreter lock in its array operations)."""
        if self._pool_obj is None:
            self._pool_obj = ThreadPoolExecutor(
                max_workers=max(1, self.num_threads), thread_name_prefix="ubt-decode",
            )
        return self._pool_obj

    def _materialize(self, item: Dict) -> Dict:
        """Read and weak-augment one geometry record's pixels; raises on a
        corrupt file (the caller replaces the sample)."""
        with span("ubt.loader.read"):
            img = self._image_loader(item["dict"]["file_name"])
        _bump("train")
        with span("ubt.loader.augment"):
            image = materialize_weak_augment(img, item["geom"])
        return dict(item, image=image)

    def _materialize_owned(self, item: Dict) -> Dict:
        """Several processes: a corrupt file gives a zero uint8 image on its
        canvas and an all-zero gt row (the sample was chosen from metadata
        on every process; its owner cannot redraw alone)."""
        try:
            return self._materialize(item)
        except Exception:  # a corrupt file: a zero row, no redraw
            _bump("corrupt")
            logger.warning("failed to load %s; feeding a zero image/gt row", item["dict"].get("file_name", "?"))
            ch, cw = item["bucket"]
            return dict(item, image=np.zeros((ch, cw, 3), np.uint8),
                        gt={k: np.zeros_like(v) for k, v in item["gt"].items()})

    def _materialized_stream(self, dicts: List[Dict], seed: int) -> Iterator[Dict]:
        """Sequential geometry draws, pixels materialized on the pool through
        a sliding window of in-flight reads that keeps sample order. A
        corrupt file is dropped and the next drawn sample takes its place,
        at most 3 in a row (data/common.py:22-43)."""
        stubs = self._stream(dicts, seed)
        warned = 0

        def corrupt(consecutive: int) -> int:
            nonlocal warned
            _bump("corrupt")
            if warned < 5:
                logger.warning("failed to decode a sample; replacing with the next drawn sample")
                warned += 1
            if consecutive + 1 >= 3:
                raise RuntimeError("3 consecutive corrupt samples")
            return consecutive + 1

        if self.num_threads <= 0:  # synchronous: exact decode accounting
            consecutive = 0
            for stub in stubs:
                try:
                    yield self._materialize(stub)
                    consecutive = 0
                except Exception:  # a corrupt file: the next sample replaces it
                    consecutive = corrupt(consecutive)
            return
        window = max(2 * self.num_threads, 8)
        futs: collections.deque = collections.deque()
        consecutive = 0
        while True:
            while len(futs) < window:
                futs.append(self._pool.submit(self._materialize, next(stubs)))
            try:
                yield futs.popleft().result()
                consecutive = 0
            except CancelledError:  # close() dropped the pending reads: no corrupt file, the stream ends
                return
            except Exception:  # a corrupt file: the next sample replaces it
                consecutive = corrupt(consecutive)

    def _assemble_local(self, label_items: List[Dict], unlabel_items: List[Dict]) -> Dict:
        """Several processes: materialize and stack only this process's rows
        of each stream's global batch."""
        lo = owned_rows(len(label_items), self.process_index, self.process_count)
        uo = owned_rows(len(unlabel_items), self.process_index, self.process_count)
        owned = label_items[lo] + unlabel_items[uo]
        if self.num_threads > 0:
            done = list(self._pool.map(self._materialize_owned, owned))
        else:
            done = [self._materialize_owned(it) for it in owned]
        nl = lo.stop - lo.start
        return self._assemble(done[:nl], done[nl:])

    def _assemble(self, label_items: List[Dict], unlabel_items: List[Dict]) -> Dict:
        def stack_gt(items, box_std: float = 0.0) -> PaddedInstances:
            return PaddedInstances(
                boxes=np.stack([it["gt"]["boxes"] for it in items]),
                classes=np.stack([it["gt"]["classes"] for it in items]),
                scores=np.ones((len(items), self.max_gt), np.float32),
                box_std=np.full((len(items), self.max_gt, 4), box_std, np.float32),
                mask=np.stack([it["gt"]["mask"] for it in items]),
            )

        out = {
            "images_label_k": np.stack([it["image"] for it in label_items]),
            "gt_label": stack_gt(label_items),
            "label_hw": np.stack([it["hw"] for it in label_items]),
            "images_unlabel_k": np.stack([it["image"] for it in unlabel_items]),
            "unlabel_hw": np.stack([it["hw"] for it in unlabel_items]),
        }
        if self.oracle:
            # TPU.ORACLE_PSEUDO: the unlabeled stream's ground truth as a
            # perfect pseudo-label set (confidence 1, std ORACLE_BOX_STD)
            out["gt_unlabel"] = stack_gt(unlabel_items, ORACLE_BOX_STD)
        return out

    def __iter__(self) -> Iterator[Dict]:
        if self.local_rows:
            # several processes: batch the geometry records; the owned rows
            # are materialized at assembly, the others never read
            items, assemble = self._stream, self._assemble_local
        else:
            # one process: pixels through the pool right after the
            # sequential geometry stream, before bucketing
            items, assemble = self._materialized_stream, self._assemble
        label_batches = self._batched_stream(items(self.label_dicts, self.seed), self.batch_label)
        unlabel_batches = self._batched_stream(items(self.unlabel_dicts, self.seed + 7), self.batch_unlabel)
        if self.num_threads <= 0:
            for lb, ub in zip(label_batches, unlabel_batches):
                yield assemble(lb, ub)
            return

        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue `item` unless the consumer has stopped; False if it has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for lb, ub in zip(label_batches, unlabel_batches):
                    if not put(assemble(lb, ub)):
                        return
            except Exception as e:  # surfaced to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True, name="ubt-batches")
        t.start()
        try:
            while True:
                PREFETCH["ready"] = q.qsize()
                with span("ubt.loader.queue_wait"):
                    item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def close(self) -> None:
        """Shut the materialize pool down (a later iteration makes a new one)."""
        if self._pool_obj is not None:
            self._pool_obj.shutdown(wait=False, cancel_futures=True)
            self._pool_obj = None


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
            _bump("test")
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
