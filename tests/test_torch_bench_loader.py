"""The port's loader benchmark (ubteacher_tpu_torch/tools/bench_loader.py):
its synthetic JPEG writer makes the JAX tool's images for the same seed
(the decoded pixels and the COCO json equal), the loader-alone pass reports
the JAX tool's fields over the batches it took, and the concurrent-step
mode, which steps the FCOS recipe on the card, stops without one unless
--cpu is given (chip_smoke.py phase 14 runs it on the card)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (few_torch_threads, tmp_budget: autouse fixtures)
    few_torch_threads,
    tmp_budget,
)
from ubteacher_tpu_torch.tools import bench_loader

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import bench_loader as jax_bench_loader  # noqa: E402  (the repo root on sys.path first)


@pytest.mark.parametrize("seed,dims", [(0, None), (5, [(96, 160), (160, 96)])], ids=["coco-like", "given-dims"])
def test_synthetic_jpegs_equal_jax(tmp_path, seed, dims):
    import cv2

    n = 6
    got = bench_loader.write_synthetic_jpegs(tmp_path / "port", n, seed=seed, dims=dims)
    ref = jax_bench_loader.write_synthetic_jpegs(tmp_path / "jax", n, seed=seed, dims=dims)
    assert json.loads(Path(got[0]).read_text()) == json.loads(Path(ref[0]).read_text())
    for i in range(n):
        a = cv2.imread(str(Path(got[1]) / f"img{i}.jpg"), cv2.IMREAD_COLOR)
        b = cv2.imread(str(Path(ref[1]) / f"img{i}.jpg"), cv2.IMREAD_COLOR)
        assert a is not None and a.shape[2] == 3
        np.testing.assert_array_equal(a, b)


def test_loader_alone_pass(tmp_path, capsys):
    """--once at 2 threads over 12 images: the JAX tool's fields, images
    decoded in the timed window and none corrupt; the summary names it."""
    out = bench_loader.main(["--images", "12", "--batches", "2", "--threads", "2", "--once",
                             "--workdir", str(tmp_path)])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == out
    rows, summary = out[:-1], out[-1]
    assert [r["threads"] for r in rows] == [2]
    for r in rows:
        assert set(r) == {"threads", "batches", "img_s", "ms_per_batch", "decodes", "corrupt", "sustains_device"}
        assert r["batches"] == 2 and r["corrupt"] == 0 and r["img_s"] > 0
        assert r["decodes"] > 0  # (images bucketed earlier may fill a timed batch)
    assert summary["best_img_s"] == max(r["img_s"] for r in rows)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the device rule without a card")
def test_concurrent_step_needs_the_card_or_cpu(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_loader.main(["--images", "2", "--threads", "0", "--concurrent-step", "--workdir", str(tmp_path)])
