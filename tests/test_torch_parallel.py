"""The port's data-parallel plumbing (ubteacher_tpu_torch.parallel and its
users) on the CPU: each process's loader rows byte for byte against the JAX
loader's for the same process_index / process_count, the row rules
(owned_rows, take_owned), allgather_host_rows on three gloo processes, and
the CLI training and evaluating on two (python -m
ubteacher_tpu_torch.train_net --num-gpus 2 MODEL.DEVICE cpu). The step and
trainer equivalence is test_torch_dp_trainer.py's."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_dp_worker as W
from test_cli import _write_coco_root
from test_torch_cli import CONFIG, _opts
from test_torch_train_loader import _batches, _cfgs, _dataset, assert_batches_equal
from torch_parity import (  # noqa: F401 (fixtures: autouse, or named in usefixtures)
    few_torch_threads,
    large_files_removed,
    tmp_budget,
)
from ubteacher_tpu.data import loader as j_loader
from ubteacher_tpu_torch import parallel, train_net
from ubteacher_tpu_torch.data import loader as t_loader
from ubteacher_tpu_torch.data.coco import generate_supervision_seed_file

FIELDS = ("boxes", "classes", "scores", "box_std", "mask")


def _loaders(cfgs, label, unlabel, image_loader, p, n):
    jcfg, tcfg = cfgs
    kw = dict(seed=5, image_loader=image_loader, process_index=p, process_count=n)
    return j_loader.TwoStreamDataLoader(jcfg, label, unlabel, **kw), t_loader.TwoStreamDataLoader(tcfg, label, unlabel, **kw)


@pytest.mark.parametrize("threads", [0, 2])
def test_each_process_rows_byte_equal_to_jax(threads):
    """Process p of 2 gets JAX's rows for p, byte for byte; the two
    processes' rows concatenated are the one-process batch; with no thread
    pool each process reads exactly its own rows."""
    images, dicts = _dataset(24)
    cfgs = _cfgs(threads=threads, batch=(4, 2), extra_canvases=[(96, 128)])
    label, unlabel = dicts[:16], dicts[16:]
    _, one = _loaders(cfgs, label, unlabel, images.__getitem__, 0, 1)
    full = _batches(one, 6)
    parts = []
    for p in range(2):
        jl, tl = _loaders(cfgs, label, unlabel, images.__getitem__, p, 2)
        before = t_loader.DECODE_STATS["train"]
        tbs = _batches(tl, 6)
        if threads == 0:
            assert t_loader.DECODE_STATS["train"] - before == 6 * (2 + 1)
        for jb, tb in zip(_batches(jl, 6), tbs):
            assert_batches_equal(jb, tb)
        parts.append(tbs)
    for f, a, b in zip(full, *parts):
        for k in f:
            if k.startswith("gt_"):
                for name in FIELDS:
                    np.testing.assert_array_equal(
                        np.concatenate([getattr(a[k], name), getattr(b[k], name)]), getattr(f[k], name))
            else:
                np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), f[k], err_msg=k)


def test_corrupt_owned_row_is_zeroed_with_its_gt():
    """A file that fails to load gives its owner a zero image and an empty
    gt row, no redraw (the other process's stream stays in step), as in
    the JAX loader (tests/test_multihost_data.py)."""
    images, dicts = _dataset(16)
    landscape = [d for d in dicts if d["width"] >= d["height"] and d["annotations"]
                 and any(not o.get("iscrowd", 0) for o in d["annotations"])]
    bad = landscape[0]["file_name"]

    def image_loader(name):
        if name == bad:
            raise IOError(f"corrupt {name}")
        return images[name]

    cfgs = _cfgs(batch=(4, 2))
    zero_rows = 0
    for p in range(2):
        jl, tl = _loaders(cfgs, landscape, dicts, image_loader, p, 2)
        before = t_loader.DECODE_STATS["corrupt"]
        tbs = _batches(tl, 6)
        for jb, tb in zip(_batches(jl, 6), tbs):
            assert_batches_equal(jb, tb)
            assert tb["images_label_k"].shape[0] == 2
            flat = tb["images_label_k"].reshape(2, -1)
            for r in np.flatnonzero((flat == 0).all(axis=1)):
                assert not tb["gt_label"].mask[r].any() and not tb["gt_label"].boxes[r].any()
                zero_rows += 1
        assert t_loader.DECODE_STATS["corrupt"] - before == sum(
            int((tb[k].reshape(len(tb[k]), -1) == 0).all(axis=1).sum())
            for tb in tbs for k in ("images_label_k", "images_unlabel_k"))
    assert zero_rows > 0


def test_row_rules_in_one_process():
    """Without a process group: one rank of one, owned_rows raises on a
    batch the ranks do not divide, take_owned and the collectives leave
    their inputs as they are."""
    assert (parallel.world_size(), parallel.rank(), parallel.is_main_process()) == (1, 0, True)
    assert parallel.owned_rows(6, 1, 3) == slice(2, 4)
    assert parallel.owned_rows(4) == slice(0, 4)
    with pytest.raises(ValueError, match="divisible"):
        parallel.owned_rows(5, 0, 2)
    x = torch.arange(12.0).reshape(6, 2)
    assert parallel.take_owned(x, [2, 4]) is x
    assert parallel.all_reduce_sum(x) is x
    rows = np.arange(6.0)
    np.testing.assert_array_equal(parallel.allgather_host_rows(rows), rows[:, None])
    assert parallel.allgather_host_rows(np.zeros((0,))).shape == (0, 1)
    assert parallel.launch(lambda a, b: a + b, 1, args=(2, 3)) == 5  # one rank, no backend: this process


def test_allgather_host_rows_on_three_processes(tmp_path):
    """Counts 2, 0 and 3: every rank gets the rows in rank order, the empty
    rank included; a 1-D input gathers as a column; no rows anywhere gives
    no rows."""
    W.start_ranks("gather_rows", 3, str(tmp_path)).wait()
    expect = np.concatenate([(100.0 * r + np.arange(n * 7)).reshape(-1, 7) for r, n in enumerate(W.GATHER_COUNTS)])
    for r in range(3):
        got = torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
        assert got["rows"].dtype == np.float64 and got["rows"].shape == (5, 7)
        np.testing.assert_array_equal(got["rows"], expect)
        np.testing.assert_array_equal(got["column"], np.arange(3, dtype=np.float32)[:, None])
        assert got["empty"].shape == (0, 5)


def _eval_lines(stdout):
    """The results dicts the ranks printed (one line each)."""
    return [eval(line, {"__builtins__": {}}, {"nan": float("nan")})  # noqa: S307 (our own printed dicts)
            for line in stdout.splitlines() if line.startswith("{") and "'AP'" in line]


@pytest.mark.usefixtures("large_files_removed")
def test_cli_on_two_processes(tmp_path, monkeypatch):
    """python -m ubteacher_tpu_torch.train_net --num-gpus 2 MODEL.DEVICE cpu
    trains on two gloo ranks: rank 0 logs finite global losses and writes
    one checkpoint; --eval-only --resume on two ranks prints the same
    metrics on both, equal to one process's evaluation of the checkpoint."""
    root = tmp_path / "coco"
    _write_coco_root(root, size=48)
    generate_supervision_seed_file(str(tmp_path / "seed.txt"), num_images=8, percents=(50.0,), seeds=1)
    monkeypatch.setenv("COCO_ROOT", str(root))
    out_dir = tmp_path / "out"
    opts = _opts(tmp_path, out_dir) + ["TEST.EVAL_PERIOD", "0", "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"]

    def cli(*flags):
        """One launch of two ranks, with the time limit counted from its own
        start."""
        argv = [sys.executable, "-m", "ubteacher_tpu_torch.train_net", "--config", CONFIG, "--num-gpus", "2",
                *flags] + opts
        return W.start(argv, W.RANKS_TIMEOUT).wait()

    cli()
    assert sorted(os.listdir(out_dir / "checkpoints")) == ["2"]
    lines = [json.loads(line) for line in (out_dir / "metrics.json").read_text().splitlines()]
    losses = [v for line in lines for k, v in line.items() if k.startswith("loss") or k == "total_loss"]
    assert losses and all(np.isfinite(v) for v in losses)
    ranks = _eval_lines(cli("--eval-only", "--resume"))
    assert len(ranks) == 2
    one = train_net.main(train_net.default_argument_parser().parse_args(
        ["--config", CONFIG, "--eval-only", "--resume"] + opts))
    keys = sorted(k for k in one if k != "inference_sec_per_image")
    fields = [np.array([r[k] for k in keys], np.float64) for r in ranks + [one]]
    np.testing.assert_array_equal(fields[0], fields[1], err_msg=str(keys))
    np.testing.assert_allclose(fields[0], fields[2], rtol=0, atol=1e-6, err_msg=str(keys))
    assert np.isfinite(one["AP"])
