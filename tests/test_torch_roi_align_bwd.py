"""The host-side pre-pass of the port's ROIAlign backward kernel
(ubteacher_tpu_torch/ops/kernels/roi_align_cuda.py: group_rois and
roi_footprints), on the CPU.

The CUDA kernel writes each tile of each level's gradient once, walking the
rois of one (image, level) segment in order and skipping those whose
footprint misses the tile. So it relies on two plain functions, held here:
  * group_rois is a stable permutation of the rois; segment image * count +
    level holds exactly the rois of that image and level, in index order,
    and a roi whose level lies outside [0, count) (a non-finite box) comes
    after every segment;
  * roi_footprints contains every nonzero of the roi's own gradient, the
    plain version's (roi_align_plain differentiated by autograd, one roi at
    a time) and the JAX reference's (the transpose of the exact
    roi_align_matmul, united over the rois of each image and level), and is
    at most two pixels wider on each side (the one-pixel margin, and a
    corner whose bilinear weight is exactly 0). Covered: sampling ratio 0
    and 2, rois clipped at the border and lying outside the map, degenerate
    rois (extent 1e-6), an oversized p5 roi whose adaptive grid is capped at
    ADAPTIVE_MAX_S, and a NaN box, which gets no footprint and no segment.
Integer outputs: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.ops.roi_align import multilevel_roi_align as j_multilevel_roi_align
from ubteacher_tpu_torch.ops.kernels.roi_align_cuda import group_rois, roi_align_plain, roi_footprints
from ubteacher_tpu_torch.ops.roi_align import ADAPTIVE_MAX_S, assign_levels

LEVELS = (2, 3, 4, 5)
SCALES = [1.0 / 2**lv for lv in LEVELS]
CANVAS = (96, 128)
SHAPES = [(CANVAS[0] >> lv, CANVAS[1] >> lv) for lv in LEVELS]
P = 7


def _boxes(case, rng, n=12):
    h, w = CANVAS
    if case == "random":
        x0, y0 = rng.uniform(0, w - 4, n), rng.uniform(0, h - 4, n)
        bw, bh = np.exp(rng.uniform(np.log(2), np.log(200), (2, n)))
        return np.stack([x0, y0, x0 + bw, y0 + bh], -1)
    if case == "border":  # samples clipped onto the first and the last pixel, or wholly outside the map
        return np.array([[-20, -10, 60, 40], [100, 80, 140, 100], [-50, -50, -10, -10], [w - 3, h - 2, w + 40, h + 30],
                         [0, 0, w, h], [w - 0.5, 10, w + 0.5, 11.5]], np.float64)
    if case == "degenerate":  # zero extents become 1e-6: one sample per axis
        return np.array([[30, 30, 30, 30], [10.5, 20.25, 10.5, 50], [64, 0, 90, 0], [w - 1, h - 1, w - 1, h - 1]], np.float64)
    if case == "oversized":  # on p5 with an extent past 7 * ADAPTIVE_MAX_S level pixels per axis
        return np.array([[-1000, -800, 1500, 1200], [-900, 10, 1200, 60], [5, 5, 20, 25]], np.float64)
    raise ValueError(case)


def _levels(boxes):
    return (assign_levels(boxes, min(LEVELS), max(LEVELS)) - min(LEVELS)).contiguous()


def _nonzero_box(g):
    """[y_lo, y_hi, x_lo, x_hi] of the nonzeros of (C, H, W), or None."""
    ys, xs = np.nonzero(np.abs(g).sum(0))
    return None if ys.size == 0 else [ys.min(), ys.max(), xs.min(), xs.max()]


@pytest.mark.parametrize("seed", [0, 1])
def test_group_rois_is_a_stable_grouping(seed):
    rng = np.random.default_rng(seed)
    b, r, count = 3, 17, 4
    level = rng.integers(0, count, b * r).astype(np.int32)
    out_of_range = [2, 20, 40]  # the levels a non-finite box can get
    level[out_of_range] = [-2, count, np.iinfo(np.int32).min]
    order, seg = group_rois(torch.from_numpy(level), b, r, count)
    assert order.dtype == torch.int64 and seg.dtype == torch.int32 and seg.shape == (b * count + 1,)
    order, seg = order.numpy(), seg.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(b * r))
    assert seg[0] == 0 and np.all(np.diff(seg) >= 0) and seg[-1] == b * r - len(out_of_range)
    for img in range(b):
        for lv in range(count):
            s = img * count + lv
            expect = [n for n in range(b * r) if n // r == img and level[n] == lv]
            np.testing.assert_array_equal(order[seg[s]:seg[s + 1]], expect, err_msg=f"image {img} level {lv}")
    np.testing.assert_array_equal(order[seg[-1]:], out_of_range)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("case", ["random", "border", "degenerate", "oversized"])
def test_footprint_contains_each_rois_plain_gradient(case, sampling_ratio):
    rng = np.random.default_rng(7 + sampling_ratio)
    boxes = torch.from_numpy(_boxes(case, rng)).float()
    level = _levels(boxes)
    if case == "oversized":
        assert int(level[0]) == 3 and float((boxes[0, 2] - boxes[0, 0]) * SCALES[3]) / P > ADAPTIVE_MAX_S
    foot = roi_footprints(boxes, level, SCALES, SHAPES, P, sampling_ratio).numpy()
    for n in range(boxes.shape[0]):
        feats = [torch.from_numpy(rng.normal(size=(1, 3, h, w)).astype(np.float32)).requires_grad_(True)
                 for h, w in SHAPES]
        out = roi_align_plain(feats, boxes[n:n + 1], level[n:n + 1], 1, SCALES, P, sampling_ratio)
        cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
        grads = torch.autograd.grad(out, feats, cot, allow_unused=True)
        for lv, g in enumerate(grads):
            nz = None if g is None else _nonzero_box(g[0].numpy())
            if lv != int(level[n]):
                assert nz is None, f"roi {n}: gradient on level {lv}, assigned {int(level[n])}"
                continue
            assert nz is not None, f"roi {n}: no gradient on its level"
            f = foot[n]
            assert f[0] <= nz[0] and nz[1] <= f[1] and f[2] <= nz[2] and nz[3] <= f[3], (n, f, nz)
            assert nz[0] - f[0] <= 2 and f[1] - nz[1] <= 2 and nz[2] - f[2] <= 2 and f[3] - nz[3] <= 2, (n, f, nz)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_footprints_cover_the_jax_gradient(sampling_ratio):
    """Every nonzero of the JAX reference's gradient (the exact matmul
    formulation's transpose) lies in the footprint of some roi of its image
    on its level."""
    rng = np.random.default_rng(11)
    b, r, c = 2, 24, 4
    h, w = CANVAS
    x0, y0 = rng.uniform(-10, w, (b, r)), rng.uniform(-10, h, (b, r))
    bw, bh = np.exp(rng.uniform(np.log(2), np.log(300), (2, b, r)))
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)
    feats = {f"p{lv}": jnp.asarray(rng.normal(size=(b, hh, ww, c)).astype(np.float32))
             for lv, (hh, ww) in zip(LEVELS, SHAPES)}
    cot = rng.normal(size=(b, r, P, P, c)).astype(np.float32)

    def ref(pyr):
        return j_multilevel_roi_align(pyr, jnp.asarray(boxes), tuple(f"p{lv}" for lv in LEVELS), P, sampling_ratio,
                                      method="matmul")

    _, vjp = jax.vjp(ref, feats)
    (grads,) = vjp(jnp.asarray(cot))
    flat = torch.from_numpy(boxes.reshape(b * r, 4))
    level = _levels(flat)
    foot = roi_footprints(flat, level, SCALES, SHAPES, P, sampling_ratio).numpy()
    for lv, (hh, ww) in enumerate(SHAPES):
        g = np.abs(np.asarray(grads[f"p{LEVELS[lv]}"])).sum(-1)  # (B, H, W)
        for img in range(b):
            covered = np.zeros((hh, ww), bool)
            for n in range(img * r, (img + 1) * r):
                if int(level[n]) == lv:
                    y_lo, y_hi, x_lo, x_hi = foot[n]
                    covered[y_lo:y_hi + 1, x_lo:x_hi + 1] = True
            assert not np.any((g[img] != 0) & ~covered), f"image {img} p{LEVELS[lv]}"


def test_nan_box_gets_no_footprint_and_no_segment():
    boxes = torch.tensor([[10.0, 10.0, 50.0, 40.0], [float("nan"), 5.0, 20.0, 30.0], [0.0, 0.0, 90.0, 90.0]])
    level = _levels(boxes)
    assert not 0 <= int(level[1]) < len(LEVELS)
    foot = roi_footprints(boxes, level, SCALES, SHAPES, P, 0)
    assert foot[1].tolist() == [0, -1, 0, -1]
    assert all(int(foot[n, 1]) >= int(foot[n, 0]) and int(foot[n, 3]) >= int(foot[n, 2]) for n in (0, 2))
    # the same box with a level forced into range still gets none
    forced = roi_footprints(boxes, torch.zeros(3, dtype=torch.int32), SCALES, SHAPES, P, 0)
    assert forced[1].tolist() == [0, -1, 0, -1]
    order, seg = group_rois(level, 1, 3, len(LEVELS))
    assert int(seg[-1]) == 2 and order[2:].tolist() == [1]
