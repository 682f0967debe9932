"""The anchor matcher kernel's culling (csrc/matcher.cu), modelled in plain
PyTorch on the CPU: each warp of 32 consecutive anchors computes only its
candidate gt slots (ops/kernels/matcher_cuda.py:warp_candidates), and pass 2
starts from what the culled pairs give. Held bitwise, on a small canvas
with the R-CNN anchor set, to the plain matcher (match_anchors_plain) and
to the JAX package's match_anchors_batched (XLA and interpreted Pallas):
labels and indices are integers, so the tolerance is equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.modeling.matcher import match_anchors_batched as j_match_anchors_batched
from ubteacher_tpu_torch.modeling.anchors import generate_anchors
from ubteacher_tpu_torch.ops.boxes import pairwise_iou
from ubteacher_tpu_torch.ops.kernels.matcher_cuda import WARP, match_anchors_plain, warp_candidates

CANVAS = (64, 96)


def _anchors():
    return generate_anchors(CANVAS, (4, 8, 16, 32, 64), [[32], [64], [128], [256], [512]], [[0.5, 1.0, 2.0]],
                            0.0, "cpu")["anchors"]


def _case(seed, anchors):
    """(B, M) gt slots with the culling's edge cases: duplicated gts, a gt
    equal to an anchor, zero-area gts, gts outside the canvas and covering
    it, non-finite gts, an image with no valid slot (ngt = 0) and one whose
    first slots are invalid."""
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    b, m = 6, 10
    xy = rng.uniform(-10, [w, h], (b, m, 2))
    wh = rng.uniform(1, 60, (b, m, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    mask = rng.random((b, m)) < 0.8
    gt[0, 3] = gt[0, 1]
    mask[0, [1, 3]] = True                               # duplicated: ties go to slot 1
    gt[1, 0] = anchors[int(rng.integers(len(anchors)))].numpy()   # IoU exactly 1
    gt[1, 1] = [20.0, 20.0, 20.0, 20.0]                  # a point
    gt[1, 2] = [30.0, 5.0, 30.0, 40.0]                   # a line
    gt[2, 0] = [-90.0, -70.0, -20.0, -5.0]               # outside the canvas
    gt[2, 1] = [w + 3.0, 0.0, w + 50.0, h]
    gt[2, 2] = [0.0, 0.0, w, h]                          # covers the canvas
    gt[2, 3] = [-0.0, -0.0, 16.0, 16.0]
    mask[1, :3] = mask[2, :4] = True
    gt[3, 0] = [np.nan, 1.0, 20.0, 20.0]                 # non-finite
    gt[3, 1] = [1.0, 1.0, np.inf, 20.0]
    gt[3, 2] = [-np.inf, -np.inf, np.inf, np.inf]
    mask[3, :3] = True
    mask[4] = False                                      # ngt = 0
    mask[5, :4] = False
    mask[5, 6] = True
    return gt, mask


def _culled_match(anchors, gt, mask, thresholds=(0.3, 0.7), labels=(0, -1, 1), allow_low_quality=True):
    """The kernel's two passes over candidate pairs only."""
    a = anchors.shape[0]
    b, m = mask.shape
    cand = warp_candidates(anchors, gt, mask).repeat_interleave(WARP, 1)[:, :a]  # (B, A, M)
    iou = torch.stack([pairwise_iou(g, anchors) for g in gt]).transpose(1, 2)  # (B, A, M)
    neg = torch.full((), -1.0)
    # pass 1: each gt's best IoU over its candidate anchors, -1 where none
    gm = torch.where(cand, iou, neg).amax(1) + 0.0  # -0.0 -> +0.0
    # pass 2: start from (0, first valid slot), or (-inf, 0) with no valid
    # slot; strict > over the candidates in slot order
    slot = torch.arange(m)
    first = torch.where(mask, slot, m).amin(-1) if m else torch.zeros(b, dtype=torch.long)
    any_valid = mask.any(-1)[:, None]
    v0 = torch.where(any_valid, 0.0, float("-inf"))
    i0 = torch.where(any_valid, first[:, None], 0)
    qc = torch.where(cand, iou, torch.full((), float("-inf")))
    best, arg = qc.amax(-1), qc.argmax(-1)
    mv = torch.where(best > v0, best, v0)
    mi = torch.where(best > v0, arg, i0)
    lab = torch.full((b, a), labels[0], dtype=torch.int64)
    lab = torch.where(mv >= thresholds[0], labels[1], lab)
    lab = torch.where(mv >= thresholds[1], labels[2], lab)
    if allow_low_quality:
        promote = (cand & (gm[:, None] > 0) & (iou == gm[:, None])).any(-1)
        lab = torch.where(promote, labels[2], lab)
    return mi, lab


@pytest.mark.parametrize("seed", range(3))
def test_culled_pairs_have_iou_exactly_zero(seed):
    anchors = _anchors()
    gt, mask = _case(seed, anchors)
    gt, mask = torch.from_numpy(gt), torch.from_numpy(mask)
    cand = warp_candidates(anchors, gt, mask).repeat_interleave(WARP, 1)[:, :anchors.shape[0]]
    iou = torch.stack([pairwise_iou(g, anchors) for g in gt]).transpose(1, 2)
    culled = mask[:, None, :] & ~cand
    assert int(culled.sum()) > 0
    assert bool((iou[culled] == 0).all())
    assert not bool(torch.signbit(iou[culled]).any())  # +0, never -0
    # a non-finite gt is always a candidate, and its IoU is 0 everywhere
    assert bool(cand[3, :, :3].all()) and bool((iou[3, :, :3] == 0).all())
    assert not bool(cand[4].any())


@pytest.mark.parametrize("allow_low_quality", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_culled_match_bitwise_equals_plain_and_jax(seed, allow_low_quality):
    anchors = _anchors()
    gt, mask = _case(seed, anchors)
    finite = mask.copy()
    finite[3, :3] = False
    # the interpreted Pallas kernel on the finite gts only: the non-finite
    # slots are held to the plain version and XLA
    for m, methods in ((mask, ("xla",)), (finite, ("xla", "auto"))):
        idx, lab = _culled_match(anchors, torch.from_numpy(gt), torch.from_numpy(m),
                                 allow_low_quality=allow_low_quality)
        p_idx, p_lab = match_anchors_plain(anchors, torch.from_numpy(gt), torch.from_numpy(m),
                                           allow_low_quality=allow_low_quality)
        assert torch.equal(idx, p_idx) and torch.equal(lab, p_lab)
        for method in methods:
            j_idx, j_lab = j_match_anchors_batched(jnp.asarray(anchors.numpy()), jnp.asarray(gt), jnp.asarray(m),
                                                   allow_low_quality=allow_low_quality, method=method)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx), err_msg=method)
            np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab), err_msg=method)
        assert int((lab == 1).sum()) > 0 and bool((lab[4] == 0).all()) and bool((idx[4] == 0).all())
        assert bool((idx[5] >= 4).all())  # the first valid slot when nothing overlaps
