"""The port's NMS on the edge cases its CUDA kernel is held to on the card,
on the CPU: the plain version (which the kernel must equal bitwise) against
ubteacher_tpu.ops.nms.nms_keep and nms_keep_pallas(interpret=True).

The kernel (csrc/nms.cu) packs the overlaps into 64-bit words of 64-row
tiles, resolves each tile's chain on its own and folds the kept rows into
the later tiles' words. So what can go wrong is at the tiles' edges: valid
counts just below, at and above a multiple of 64, a candidate count K that
is not a multiple of 64, suppression chains that cross from one tile into
the next, and several rows of one batched call with different counts. Each
case is held here, keep masks exact (boolean outputs, boxes whose IoUs keep
clear of the threshold by more than 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.ops.nms import nms_keep as j_nms_keep
from ubteacher_tpu.ops.pallas import nms_keep_pallas
from ubteacher_tpu_torch.ops.kernels import nms_cuda
from ubteacher_tpu_torch.ops.nms import nms_keep


def _clustered(rng, n, centres=8, spread=6.0):
    """Boxes crowded around a few centres, so suppression chains form."""
    ctr = rng.random((centres, 2))[rng.integers(0, centres, n)] * 300.0 + rng.normal(0, spread, (n, 2))
    wh = rng.random((n, 2)) * 40.0 + 10.0
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


def _staircase(n, step=12.0, width=100.0):
    """Each box overlaps its neighbours at IoU 0.79 and the boxes two apart
    at 0.61: at t 0.7 greedy keeps every other box, a chain as long as the
    list."""
    x = np.arange(n, dtype=np.float32) * step
    return np.stack([x, np.zeros(n, np.float32), x + width, np.full(n, 100.0, np.float32)], 1)


def _margin(boxes, t):
    b = boxes.astype(np.float64)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = np.clip(np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    return np.abs(inter / (area[:, None] + area[None, :] - inter) - t).min()


def _check(boxes, scores, valid, t):
    assert _margin(boxes, t) > 1e-5
    got = nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), t).numpy()
    ref = np.asarray(j_nms_keep(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), t))
    pal = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), t, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    return got


@pytest.mark.parametrize("n_valid", [63, 64, 65, 127, 128, 129, 200])
def test_valid_count_around_tile_edges(n_valid):
    """K = 200, not a multiple of 64; the valid candidates are the
    n_valid highest-scoring ones, so the last valid tile is cut at n_valid."""
    rng = np.random.default_rng(n_valid)
    k = 200
    boxes = _clustered(rng, k)
    scores = rng.random(k).astype(np.float32)
    valid = np.zeros(k, bool)
    valid[np.argsort(-scores)[:n_valid]] = True
    keep = _check(boxes, scores, valid, 0.6)
    assert not keep[~valid].any()


@pytest.mark.parametrize("n", [65, 130, 300])
def test_staircase_chain_crosses_tiles(n):
    """The chain runs through every tile: a candidate of tile k + 1 is kept
    or not by a candidate of tile k that was itself decided by the chain."""
    boxes = _staircase(n)
    scores = np.linspace(1.0, 0.01, n).astype(np.float32)
    keep = _check(boxes, scores, np.ones(n, bool), 0.7)
    np.testing.assert_array_equal(keep, np.arange(n) % 2 == 0)


def test_staircase_in_reverse_score_order():
    """The same chain with the scores reversed, so sorting reverses it:
    the kept set is every other box counted from the last."""
    n = 129
    boxes = _staircase(n)
    scores = np.linspace(0.01, 1.0, n).astype(np.float32)
    keep = _check(boxes, scores, np.ones(n, bool), 0.7)
    np.testing.assert_array_equal(keep, (n - 1 - np.arange(n)) % 2 == 0)


def test_rows_of_one_call_with_counts_around_tile_edges():
    """One batched call of rows with valid counts 0, 1, 63, 64, 65 and K,
    as the kernel sees an RPN call's rows; each row equals its own
    reference."""
    rng = np.random.default_rng(11)
    k = 200
    counts = [0, 1, 63, 64, 65, k]
    boxes = np.stack([_clustered(rng, k) for _ in counts])
    scores = rng.random((len(counts), k)).astype(np.float32)
    valid = np.zeros((len(counts), k), bool)
    for i, c in enumerate(counts):
        valid[i, rng.choice(k, c, replace=False)] = True
    got = nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.6).numpy()
    for i in range(len(counts)):
        assert _margin(boxes[i], 0.6) > 1e-5
        ref = np.asarray(j_nms_keep(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]), 0.6))
        pal = np.asarray(nms_keep_pallas(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]), 0.6,
                                         interpret=True))
        np.testing.assert_array_equal(got[i], ref, err_msg=f"row {i}")
        np.testing.assert_array_equal(got[i], pal, err_msg=f"row {i}")
        assert got[i].sum() <= counts[i]


def test_sorted_keep_ignores_rows_past_the_valid_count():
    """nms_sorted_keep_plain, the kernel's plain version, on sorted rows:
    the rows past nvalid are never kept, whatever their boxes, and the
    valid prefix is kept exactly as with those rows removed."""
    rng = np.random.default_rng(12)
    k, nv = 150, 70
    boxes = _clustered(rng, k)
    full = nms_cuda.nms_sorted_keep_plain(torch.from_numpy(boxes)[None], torch.tensor([nv], dtype=torch.int32), 0.6)
    cut = nms_cuda.nms_sorted_keep_plain(torch.from_numpy(boxes[:nv])[None], torch.tensor([nv], dtype=torch.int32),
                                         0.6)
    assert not full[0, nv:].any()
    np.testing.assert_array_equal(full[0, :nv].numpy(), cut[0].numpy())
