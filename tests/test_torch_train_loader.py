"""The port's weak augmentation and TwoStreamDataLoader against
ubteacher_tpu's, on the same seeded in-memory images: every batch must be
equal byte for byte (keys, dtypes, shapes and values), and so must the
DECODE_STATS counts of the synchronous path.

The JAX loader resizes with cv2.resize INTER_LINEAR, the port with its numpy
replica (data/loader.py:resize_bilinear), so byte equality here also holds
the replica to cv2 at the loader's sizes: downscales, upscales, exact 2x
downscales, crops and flips, uint8 throughout.
"""

import numpy as np
import pytest

from ubteacher_tpu.config import add_ubteacher_config as j_add, get_cfg as j_get
from ubteacher_tpu.data import augment as j_augment
from ubteacher_tpu.data import loader as j_loader
from ubteacher_tpu_torch.config import add_ubteacher_config as t_add, get_cfg as t_get
from ubteacher_tpu_torch.data import augment as t_augment
from ubteacher_tpu_torch.data import loader as t_loader

FIELDS = ("boxes", "classes", "scores", "box_std", "mask")


def _cfgs(threads=0, extra_canvases=(), crop=None, oracle=False, sampling="range"):
    out = []
    for get, add in ((j_get, j_add), (t_get, t_add)):
        cfg = get()
        add(cfg)
        cfg.TPU.CANVAS_LANDSCAPE = (64, 96)
        cfg.TPU.CANVAS_PORTRAIT = (96, 64)
        cfg.TPU.EXTRA_TRAIN_CANVASES = [list(c) for c in extra_canvases]
        cfg.TPU.MAX_GT = 6
        cfg.TPU.DATA_THREADS = threads
        cfg.TPU.ORACLE_PSEUDO = oracle
        cfg.SOLVER.IMG_PER_BATCH_LABEL = 3
        cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 2
        cfg.INPUT.MIN_SIZE_TRAIN = (30, 90) if sampling == "range" else (32, 48, 64)
        cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING = sampling
        cfg.INPUT.MAX_SIZE_TRAIN = 120
        if crop is not None:
            cfg.INPUT.CROP.ENABLED = True
            cfg.INPUT.CROP.TYPE, cfg.INPUT.CROP.SIZE = crop
        cfg.freeze()
        out.append(cfg)
    return out


def _dataset(n, seed=3):
    """Landscape and portrait images of sizes 24-110 (some exactly twice a
    jittered size), each with up to 8 boxes, a crowd box on every fourth,
    one crowd-only image and one without annotations."""
    rng = np.random.default_rng(seed)
    images, dicts = {}, []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(24, 110, 2))
        if i % 5 == 0:
            h, w = 64, 96  # 2x of the (32, 48) jitter: cv2's area-mean path
        name = f"img{i}"
        images[name] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        annos = []
        for j in range(int(rng.integers(1, 9))):
            x0, y0 = rng.uniform(0, w - 6), rng.uniform(0, h - 6)
            x1, y1 = rng.uniform(x0 + 2, w), rng.uniform(y0 + 2, h)
            annos.append({"bbox": [x0, y0, x1, y1], "category_id": int(rng.integers(0, 5)),
                          "iscrowd": int(i % 4 == 0 and j == 0)})
        if i == 7:
            annos = [dict(a, iscrowd=1) for a in annos]  # filtered from the labeled stream
        if i == 11:
            annos = []
        dicts.append({"file_name": name, "image_id": i, "height": h, "width": w, "annotations": annos})
    return images, dicts


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def assert_batches_equal(jb, tb):
    assert list(jb) == list(tb)
    for k in jb:
        if k.startswith("gt_"):
            for f in FIELDS:
                a, b = np.asarray(getattr(jb[k], f)), getattr(tb[k], f)
                assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (k, f)
                np.testing.assert_array_equal(b, a, err_msg=f"{k}.{f}")
        else:
            a, b = np.asarray(jb[k]), tb[k]
            assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(b, a, err_msg=k)


def _both(cfgs, label, unlabel, image_loader, seed=0):
    jcfg, tcfg = cfgs
    return (j_loader.TwoStreamDataLoader(jcfg, label, unlabel, seed=seed, image_loader=image_loader,
                                         process_index=0, process_count=1),
            t_loader.TwoStreamDataLoader(tcfg, label, unlabel, seed=seed, image_loader=image_loader))


CASES = {
    "sync": {},
    "pooled": {"threads": 3},
    "buckets": {"extra_canvases": [(96, 128), (128, 96)]},
    "buckets_pooled_choice": {"threads": 2, "extra_canvases": [(96, 128)], "sampling": "choice"},
    "crop_relative_range": {"crop": ("relative_range", [0.5, 0.6])},
    "crop_absolute_range": {"crop": ("absolute_range", [20, 60]), "threads": 2},
    "oracle": {"oracle": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_batches_byte_equal_to_jax(case):
    images, dicts = _dataset(24)
    cfgs = _cfgs(**CASES[case])
    jl, tl = _both(cfgs, dicts[:16], dicts[16:], images.__getitem__, seed=5)
    assert [d["image_id"] for d in tl.label_dicts] == [d["image_id"] for d in jl.label_dicts]
    assert 7 not in [d["image_id"] for d in tl.label_dicts]  # crowd-only: filtered
    jbs, tbs = _batches(jl, 8), _batches(tl, 8)
    shapes = set()
    for jb, tb in zip(jbs, tbs):
        assert_batches_equal(jb, tb)
        shapes.add(tb["images_label_k"].shape[1:3])
        shapes.add(tb["images_unlabel_k"].shape[1:3])
        assert tb["images_label_k"].dtype == np.uint8
    assert {(64, 96), (96, 64)} <= shapes  # both orientations
    if "extra_canvases" in CASES[case]:
        assert (96, 128) in shapes  # a scale bucket
    if CASES[case].get("oracle"):
        assert (tbs[0]["gt_unlabel"].box_std == t_loader.ORACLE_BOX_STD).all()


def test_crowd_boxes_are_dropped():
    """A crowd annotation never becomes a training box (the reference drops
    iscrowd != 0 in the mapper); with one crowd and one plain box per image,
    each row holds exactly the plain box, in both packages."""
    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    dicts = [{"file_name": "x", "image_id": i, "height": 48, "width": 64, "annotations": [
        {"bbox": [4, 4, 20, 20], "category_id": 3, "iscrowd": 0},
        {"bbox": [0, 0, 47, 47], "category_id": 7, "iscrowd": 1}]} for i in range(6)]
    jl, tl = _both(_cfgs(), dicts, dicts, lambda _: img)
    jb, tb = _batches(jl, 1)[0], _batches(tl, 1)[0]
    assert_batches_equal(jb, tb)
    assert tb["gt_label"].mask.sum(1).tolist() == [1, 1, 1]
    assert (tb["gt_label"].classes[:, 0] == 3).all()


@pytest.mark.parametrize("threads", [0, 2])
def test_corrupt_redraw_policy_matches_jax(threads):
    """A file that fails to load is replaced by the next drawn sample in
    both packages; the synchronous path's DECODE_STATS move alike."""
    images, dicts = _dataset(16)
    bad = {dicts[2]["file_name"], dicts[9]["file_name"]}

    def image_loader(name):
        if name in bad:
            raise IOError(f"corrupt {name}")
        return images[name]

    jl, tl = _both(_cfgs(threads=threads), dicts[:10], dicts[10:] + dicts[:3], image_loader)
    j0, t0 = dict(j_loader.DECODE_STATS), dict(t_loader.DECODE_STATS)
    jbs = _batches(jl, 6)
    j1 = dict(j_loader.DECODE_STATS)
    tbs = _batches(tl, 6)
    t1 = dict(t_loader.DECODE_STATS)
    for jb, tb in zip(jbs, tbs):
        assert_batches_equal(jb, tb)
    assert t1["corrupt"] > t0["corrupt"]
    if threads == 0:  # exact accounting
        for k in ("train", "corrupt"):
            assert t1[k] - t0[k] == j1[k] - j0[k], k


@pytest.mark.parametrize("threads", [0, 2])
def test_three_corrupt_in_a_row_raises(threads):
    images, dicts = _dataset(8)

    def image_loader(name):
        raise IOError("corrupt")

    _, tl = _both(_cfgs(threads=threads), dicts, dicts, image_loader)
    with pytest.raises(RuntimeError, match="3 consecutive corrupt"):
        _batches(tl, 1)


@pytest.mark.parametrize("crop", [None, ("relative", [0.7, 0.8]), ("relative_range", [0.5, 0.5]),
                                  ("absolute", [30, 50]), ("absolute_range", [20, 70])])
def test_weak_augment_matches_jax(crop):
    """apply_weak_augment: the same draws, boxes, keep mask, canvas and
    pixels as the JAX function, over sizes and scale buckets."""
    rng = np.random.default_rng(11)
    canvases = [(64, 96), (128, 192)]
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(20, 150, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        boxes = np.sort(rng.uniform(0, min(h, w), (5, 4)), axis=1).astype(np.float32)[:, [0, 1, 2, 3]]
        seed = int(rng.integers(1 << 30))
        args = (img, boxes, canvases, (24, 150), 200, "range")
        j = j_augment.apply_weak_augment(*args, np.random.default_rng(seed), crop=crop)
        t = t_augment.apply_weak_augment(*args, np.random.default_rng(seed), crop=crop)
        assert j["canvas"] == t["canvas"]
        assert t["image"].dtype == j["image"].dtype == np.uint8
        for k in ("image", "boxes", "hw", "keep"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_multi_process_rows_wait_for_ddp():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError):
        t_loader.TwoStreamDataLoader(tcfg, [], [], process_index=0, process_count=2)
