"""The port's ROIAlign forward on the edge cases its CUDA kernel is held to
on the card, on the CPU: the plain version (roi_align_plain, which the
kernel must match to 1e-5 in float32) against the JAX reference's exact
formulation (ubteacher_tpu.ops.roi_align.roi_align_matmul) roi group by roi
group, each group pooled from the level the port gives it.

The kernel (csrc/roi_align.cu) stages each roi's footprint, the pixel
rectangle between the first and the last bilinear tap, and contracts it
with separable bin weights. That rests on the sample positions being
monotone along each axis after clipping, which is held here on the same
boxes. Covered: sampling ratio 0 (the adaptive grid, capped at
ADAPTIVE_MAX_S for an oversized roi) and 2, P = 7 and 5, rois across and on
the canvas border, rois wholly outside the map, degenerate rois (extent
1e-6), whole-canvas rois pooled from p2 (the kernel's direct path at the
main path's canvas), and a NaN box, whose level lies out of range and whose
output is NaN in the plain version as in the kernel. The output is the JAX
layout (N, P, P, C), contiguous, so the box head's reshape is a view.

Tolerance: 1e-5 (rtol and atol), as tests/test_torch_rcnn_ops.py: the port
sums the bilinear taps of a gather, the reference contracts dense weight
rows; float32 sums in two orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.ops.roi_align import roi_align_matmul as j_roi_align_matmul
from ubteacher_tpu_torch.modeling.fast_rcnn import FastRCNNConvFCHead
from ubteacher_tpu_torch.ops.kernels.roi_align_cuda import roi_align_plain
from ubteacher_tpu_torch.ops.roi_align import assign_levels, multilevel_roi_align, sample_coords

LEVELS = (2, 3, 4, 5)
SCALES = [1.0 / 2**lv for lv in LEVELS]
CANVAS = (96, 128)
B, C = 2, 6


def _feats(rng):
    return [rng.normal(size=(B, C, CANVAS[0] >> lv, CANVAS[1] >> lv)).astype(np.float32) for lv in LEVELS]


def _boxes(case, rng, r=10):
    h, w = CANVAS
    if case == "random":
        x0, y0 = rng.uniform(0, w - 4, B * r), rng.uniform(0, h - 4, B * r)
        bw, bh = np.exp(rng.uniform(np.log(2), np.log(200), (2, B * r)))
        return np.stack([x0, y0, x0 + bw, y0 + bh], -1)
    if case == "border":  # samples clipped onto the first and the last pixel, or wholly outside the map
        edge = [[-20, -10, 60, 40], [100, 80, 140, 100], [-50, -50, -10, -10], [w - 3, h - 2, w + 40, h + 30],
                [0, 0, w, h], [w - 0.5, 10, w + 0.5, 11.5], [30, 0, 90, 1], [0, 40, 2, h]]
        return np.concatenate([edge, _boxes("random", rng, r)[:B * r - len(edge)]])
    if case == "degenerate":  # zero extents become 1e-6: one sample per axis
        deg = [[30, 30, 30, 30], [10.5, 20.25, 10.5, 50], [64, 0, 90, 0], [w - 1, h - 1, w - 1, h - 1]]
        return np.concatenate([deg, _boxes("random", rng, r)[:B * r - len(deg)]])
    if case == "oversized":  # whole-canvas and wider rois
        big = [[0, 0, w, h], [-100, -100, w + 100, h + 100], [0, 40, w, 44], [-1000, -800, 1500, 1200]]
        return np.concatenate([big, _boxes("random", rng, r)[:B * r - len(big)]])
    raise ValueError(case)


def _levels(boxes, case):
    level = (assign_levels(boxes, min(LEVELS), max(LEVELS)) - min(LEVELS)).contiguous()
    if case == "oversized":
        level[:4] = 0  # pooled from p2, whatever their size
    return level


def _reference(feats, boxes, level, p, sampling_ratio, r):
    """roi_align_matmul per (image, level) group of rois -> (N, P, P, C)."""
    out = np.zeros((boxes.shape[0], p, p, C), np.float32)
    img = np.arange(boxes.shape[0]) // r
    for b in range(B):
        for lv, scale in enumerate(SCALES):
            sel = np.nonzero((img == b) & (level == lv))[0]
            if sel.size:
                hwc = jnp.asarray(feats[lv][b].transpose(1, 2, 0))
                out[sel] = np.asarray(j_roi_align_matmul(hwc, jnp.asarray(boxes[sel]), scale, p, sampling_ratio))
    return out


@pytest.mark.parametrize("seed,case,p,sampling_ratio", [
    (0, "random", 7, 0), (1, "random", 7, 2), (2, "random", 5, 0), (3, "border", 7, 0), (4, "border", 7, 2),
    (5, "degenerate", 7, 0), (6, "oversized", 7, 0),
])
def test_forward_matches_jax(seed, case, p, sampling_ratio):
    rng = np.random.default_rng(seed)
    feats = _feats(rng)
    r = 10
    boxes = torch.from_numpy(_boxes(case, rng, r).astype(np.float32))
    level = _levels(boxes, case)
    out = roi_align_plain([torch.from_numpy(f) for f in feats], boxes, level, r, SCALES, p, sampling_ratio)
    assert out.shape == (B * r, p, p, C) and out.is_contiguous() and out.dtype == torch.float32
    ref = _reference(feats, boxes.numpy(), level.numpy(), p, sampling_ratio, r)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,sampling_ratio", [("random", 0), ("border", 0), ("degenerate", 2), ("oversized", 0)])
def test_sample_positions_are_monotone(case, sampling_ratio):
    """Along each axis the clipped sample positions never decrease from
    bin to bin and sample to sample, so the first and the last tap bound
    the pixels a roi reads (the kernel's footprint)."""
    rng = np.random.default_rng(3)
    boxes = torch.from_numpy(_boxes(case, rng).astype(np.float32))
    level = _levels(boxes, case)
    for lv, scale in enumerate(SCALES):
        sel = level == lv
        if not sel.any():
            continue
        h, w = CANVAS[0] >> LEVELS[lv], CANVAS[1] >> LEVELS[lv]
        ys, cy, xs, cx = sample_coords(boxes[sel], scale, 7, sampling_ratio)
        for pos, coef, length in ((ys, cy, h), (xs, cx, w)):
            pos = pos.clamp(0.0, length - 1.0)
            for row, c in zip(pos.reshape(pos.shape[0], -1), coef.reshape(coef.shape[0], -1)):
                v = row[c > 0]
                assert bool((v[1:] >= v[:-1]).all())
                lo = torch.floor(v)
                hi = torch.clamp(lo + 1, max=length - 1)
                assert bool((lo[1:] >= lo[:-1]).all()) and bool((hi[1:] >= hi[:-1]).all())


def test_nan_box_gets_nan_and_leaves_the_others():
    """A NaN box has no level in range: its rows are NaN, the other rois
    are pooled as without it."""
    rng = np.random.default_rng(4)
    feats = [torch.from_numpy(f) for f in _feats(rng)]
    r = 10
    boxes = torch.from_numpy(_boxes("random", rng, r).astype(np.float32))
    bad = boxes.clone()
    bad[3] = float("nan")
    level = _levels(bad, "random")
    assert not 0 <= int(level[3]) < len(LEVELS)
    out = roi_align_plain(feats, bad, level, r, SCALES, 7, 0)
    ref = roi_align_plain(feats, boxes, _levels(boxes, "random"), r, SCALES, 7, 0)
    assert bool(out[3].isnan().all())
    keep = torch.arange(B * r) != 3
    torch.testing.assert_close(out[keep], ref[keep], rtol=0, atol=0)


def test_pooled_layout_is_what_the_box_head_reads():
    """multilevel_roi_align returns (B, R, P, P, C) contiguous in the
    feature dtype, so the box head's flatten to (B, R, P * P * C) is a view
    of it, with C fastest as the JAX layout and fc1's weight rows expect."""
    rng = np.random.default_rng(5)
    feats = [torch.from_numpy(f) for f in _feats(rng)]
    boxes = torch.from_numpy(_boxes("random", rng).astype(np.float32)).reshape(B, -1, 4)
    out = multilevel_roi_align(feats, boxes, LEVELS, 7, 0)
    assert out.shape == (B, boxes.shape[1], 7, 7, C) and out.is_contiguous()
    flat = out.reshape(*out.shape[:-3], -1)
    assert flat.data_ptr() == out.data_ptr() and flat.shape == (B, boxes.shape[1], 7 * 7 * C)
    head = FastRCNNConvFCHead(7 * 7 * C, 16, 1)
    torch.testing.assert_close(head(out), torch.relu(head.fc1(flat)))


def bf16_errors(seed=0, r=10):
    """Max abs error against the float32 exact result, on the same bf16
    features, of the JAX reference in bf16 (roi_align_matmul, which casts
    the bin weights to the feature dtype, ubteacher_tpu/ops/roi_align.py:185)
    and of the port's plain version in bf16 (weights kept in float32):
    (port error, JAX error, largest |output|)."""
    rng = np.random.default_rng(seed)
    feats16 = [torch.from_numpy(f).bfloat16() for f in _feats(rng)]
    feats32 = [f.float().numpy() for f in feats16]
    boxes = torch.from_numpy(_boxes("random", rng, r).astype(np.float32))
    level = _levels(boxes, "random")
    truth = _reference(feats32, boxes.numpy(), level.numpy(), 7, 0, r)
    port = roi_align_plain(feats16, boxes, level, r, SCALES, 7, 0).float().numpy()
    img = np.arange(boxes.shape[0]) // r
    jax16 = np.zeros_like(truth)
    for b in range(B):
        for lv, scale in enumerate(SCALES):
            sel = np.nonzero((img == b) & (level.numpy() == lv))[0]
            if sel.size:
                hwc = jnp.asarray(feats32[lv][b].transpose(1, 2, 0), dtype=jnp.bfloat16)
                jax16[sel] = np.asarray(j_roi_align_matmul(hwc, jnp.asarray(boxes.numpy()[sel]), scale, 7, 0),
                                        dtype=np.float32)
    return float(np.abs(port - truth).max()), float(np.abs(jax16 - truth).max()), float(np.abs(truth).max())


@pytest.mark.parametrize("seed", range(3))
def test_bf16_no_less_accurate_than_jax_bf16(seed):
    """A kept deviation (ROADMAP Queue C): in bf16 the JAX package rounds the
    bin weights to bf16, the port keeps them in float32. On the same bf16
    features the port's error against the float32 result is no larger than
    the JAX reference's."""
    port_err, jax_err, _ = bf16_errors(seed)
    assert port_err <= jax_err
