"""Host loader throughput (port of the JAX package's tools/bench_loader.py).

Whether `TwoStreamDataLoader` (cv2 decode from disk, weak augmentation and
canvas padding on TPU.DATA_THREADS threads) sustains the img/s the card's
step consumes. Writes N synthetic JPEGs at COCO-marginal sizes (the COCO
train2017 sizes are dominated by 640x480 / 500x375-class images), then
takes batches from the loader alone and reports the sustained img/s for
each thread count: a host benchmark, no device.

With --concurrent-step the loader is timed while the port's FCOS mutual
step (8 + 8 images at 768x1344, seeded weights, tools/common.py:step_setup)
runs in a thread of the same process, with the trainer's one wait for the
device a step (its metrics fetch): the loader's threads share the
interpreter lock with the step's launches, the one structural risk of
decoding on threads. It reports the loader's img/s in that window
(`loader_img_s`), the steps a second (`step_s`) and the step loop's img/s
(`device_img_s_during`). That mode runs on the first card unless --cpu.

Usage:
    python -m ubteacher_tpu_torch.tools.bench_loader [--images 400] [--batches 40]
        [--threads 0 1 2 4 8] [--once] [--concurrent-step [--cpu]] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from .common import FCOS_CFG, device_label, load_cfg, tool_device, triton_cache_in_checkout

# COCO train2017 marginal sizes: most images are max-dim 640 with a mix of
# 4:3 / 3:4 / wider (the JAX tool's list; recipe_mix.py samples it too)
COCO_LIKE_DIMS = [
    (480, 640), (640, 480), (427, 640), (640, 427), (375, 500),
    (426, 640), (612, 612), (640, 360),
]
# --once: a short pass (a smoke run's window)
ONCE_BATCHES, ONCE_WARMUP = 16, 2


def write_synthetic_jpegs(root: Path, n: int, seed: int = 0, dims=None):
    """n JPEGs of smooth content and rectangles (a realistic decode cost:
    pure-noise JPEGs are large and slow) and their COCO json, the JAX
    tool's images for the same seed. dims: (h, w) sizes in place of
    COCO_LIKE_DIMS. -> (json path, image dir)."""
    import cv2

    rng = np.random.default_rng(seed)
    if dims is None:
        dims = COCO_LIKE_DIMS
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n):
        h, w = dims[int(rng.integers(len(dims)))]
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack(
            [(128 + 100 * np.sin(xx / (20 + 10 * c) + i + c)).astype(np.uint8) for c in range(3)],
            axis=-1,
        )
        for _ in range(int(rng.integers(1, 6))):
            bw, bh = int(rng.integers(40, w // 2)), int(rng.integers(40, h // 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y: y + bh, x: x + bw] = rng.integers(0, 255, size=3)
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": 1,
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
            })
            ann_id += 1
        fname = f"img{i}.jpg"
        cv2.imwrite(str(img_dir / fname), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append({"id": i, "file_name": fname, "height": h, "width": w})
    coco = {"images": images, "annotations": annotations, "categories": [{"id": 1, "name": "thing"}]}
    (root / "instances.json").write_text(json.dumps(coco))
    return str(root / "instances.json"), str(img_dir)


def build_cfg(threads: int):
    """The recipe's geometry: 768x1344 canvases and their buckets, 8 + 8
    images, the COCO jitter; `threads` decode threads."""
    return load_cfg(["SOLVER.IMG_PER_BATCH_LABEL", "8", "SOLVER.IMG_PER_BATCH_UNLABEL", "8",
                     "TPU.DATA_THREADS", str(threads)], FCOS_CFG)


def _take(it, batches: int) -> tuple:
    """(images, seconds) of `batches` batches taken from `it`."""
    t0 = time.perf_counter()
    n_img = 0
    for _ in range(batches):
        b = next(it)
        n_img += b["images_label_k"].shape[0] + b["images_unlabel_k"].shape[0]
    return n_img, time.perf_counter() - t0


def bench_one(dicts, threads: int, batches: int, warmup: int = 4) -> dict:
    """The loader alone: img/s over `batches` batches after `warmup`."""
    from ..data import loader as loader_mod
    from ..data.loader import TwoStreamDataLoader

    dl = TwoStreamDataLoader(build_cfg(threads), dicts, dicts, seed=0, process_index=0, process_count=1)
    it = iter(dl)
    try:
        for _ in range(warmup):
            next(it)
        d0 = dict(loader_mod.DECODE_STATS)
        n_img, dt = _take(it, batches)
        d1 = dict(loader_mod.DECODE_STATS)
    finally:
        it.close()
        dl.close()
    return {
        "threads": threads,
        "batches": batches,
        "img_s": round(n_img / dt, 1),
        "ms_per_batch": round(1e3 * dt / batches, 1),
        "decodes": d1["train"] - d0["train"],
        "corrupt": d1["corrupt"] - d0["corrupt"],
    }


def bench_concurrent(dicts, threads: int, batches: int, device, canvas=(768, 1344), batch: int = 8,
                     warmup: int = 4) -> dict:
    """The loader's img/s while the FCOS mutual step loops on `device` in a
    thread of this process (the trainer's per-step metrics fetch
    included), and the step loop's own rate over the same window."""
    import torch

    from ..data import loader as loader_mod
    from ..data.loader import TwoStreamDataLoader
    from .common import step_setup

    _, (_, mutual_step), state, dev_batch = step_setup(False, device, batch=batch, canvas=canvas)
    print("# first mutual step (warm-up)...", file=sys.stderr)
    state, met = mutual_step(state, dev_batch)
    float(met["total_loss"])

    stop = threading.Event()
    steps_done = [0]
    failure = []

    def stepper():
        nonlocal state
        try:
            while not stop.is_set():
                state, met = mutual_step(state, dev_batch)
                float(met["total_loss"])  # the trainer's one wait for the device a step
                steps_done[0] += 1
        except BaseException as e:  # surfaced after the window
            failure.append(e)

    dl = TwoStreamDataLoader(build_cfg(threads), dicts, dicts, seed=0, process_index=0, process_count=1)
    it = iter(dl)
    t = threading.Thread(target=stepper, daemon=True)
    try:
        for _ in range(warmup):  # loader warm-up before the window opens
            next(it)
        t.start()
        time.sleep(2)  # the step loop reaches its steady state
        s0 = steps_done[0]
        d0 = dict(loader_mod.DECODE_STATS)
        n_img, dt = _take(it, batches)
        s1 = steps_done[0]
        d1 = dict(loader_mod.DECODE_STATS)
    finally:
        stop.set()
        if t.is_alive():
            t.join(timeout=120)
        it.close()
        dl.close()
    if failure:
        raise failure[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "mode": "concurrent_step",
        "threads": threads,
        "batches": batches,
        "loader_img_s": round(n_img / dt, 1),
        "step_s": round((s1 - s0) / dt, 3),
        "device_img_s_during": round(2.0 * batch * (s1 - s0) / dt, 1),
        "decodes": d1["train"] - d0["train"],
        "corrupt": d1["corrupt"] - d0["corrupt"],
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", type=int, default=400)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--threads", type=int, nargs="+", default=[0, 1, 2, 4, 8])
    ap.add_argument("--device-img-s", type=float, default=55.0,
                    help="the device's demand to compare against (img/s)")
    ap.add_argument("--concurrent-step", action="store_true",
                    help="time the loader while the FCOS mutual step loops on the card in this process")
    ap.add_argument("--cpu", action="store_true", help="--concurrent-step: step on the CPU")
    ap.add_argument("--once", action="store_true",
                    help=f"a short pass: at most {ONCE_BATCHES} timed batches after {ONCE_WARMUP} warm-up batches")
    ap.add_argument("--workdir", default=None,
                    help="where the JPEGs go (default: a new temporary directory); --images JPEGs already there "
                         "are reused")
    args = ap.parse_args(argv)

    from ..data.coco import load_coco_json

    root = Path(args.workdir or tempfile.mkdtemp(prefix="ubt_loaderbench_"))
    json_path, img_dir = str(root / "instances.json"), str(root / "images")
    if os.path.exists(json_path) and len(json.loads(Path(json_path).read_text())["images"]) == args.images:
        print(f"# reusing the {args.images} jpegs at {img_dir}", file=sys.stderr)
    else:
        t0 = time.perf_counter()
        json_path, img_dir = write_synthetic_jpegs(root, args.images)
        print(f"# wrote {args.images} jpegs in {time.perf_counter() - t0:.1f}s at {img_dir}", file=sys.stderr)
    dicts, _ = load_coco_json(json_path, img_dir)

    warmup, batches = (ONCE_WARMUP, min(args.batches, ONCE_BATCHES)) if args.once else (4, args.batches)
    results = []
    if args.concurrent_step:
        device = tool_device(args.cpu)
        triton_cache_in_checkout()
        for t in args.threads:
            r = bench_concurrent(dicts, t, batches, device, warmup=warmup)
            r["sustains_device"] = r["loader_img_s"] >= r["device_img_s_during"]
            r["device"] = device_label(device)
            results.append(r)
            print(json.dumps(r))
        return results

    for t in args.threads:
        r = bench_one(dicts, t, batches, warmup=warmup)
        r["sustains_device"] = r["img_s"] >= args.device_img_s
        results.append(r)
        print(json.dumps(r))
    best = max(results, key=lambda r: r["img_s"])
    summary = {
        "best_threads": best["threads"],
        "best_img_s": best["img_s"],
        "device_img_s": args.device_img_s,
        "headroom_x": round(best["img_s"] / args.device_img_s, 2),
    }
    print(json.dumps(summary))
    return results + [summary]


if __name__ == "__main__":
    main()
