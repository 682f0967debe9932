"""The port's box ops, losses and NMS against ubteacher_tpu's, on the CPU.

The focal and GIoU losses here are the plain versions of the port's hand-written
kernels, held against both the JAX package's jnp losses and its Pallas
kernels in interpret mode (as tests/test_pallas_kernels.py runs them),
forward and gradient, to rtol 1e-5. NMS must keep exactly the same set as
ops.nms.nms_keep and nms_keep_pallas(interpret=True) on boxes whose IoUs
keep clear of the threshold. The kernel wrappers take the plain versions
for CPU tensors, so these tests go through the wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.ops import boxes as JB
from ubteacher_tpu.ops import losses as JL
from ubteacher_tpu.ops.nms import batched_nms_keep as j_batched_nms_keep
from ubteacher_tpu.ops.nms import nms_keep as j_nms_keep
from ubteacher_tpu.ops.nms import top_k_detections as j_top_k
from ubteacher_tpu.ops.pallas import (
    giou_loss_pallas,
    nms_keep_pallas,
    sigmoid_focal_loss_pallas,
)
from ubteacher_tpu_torch.ops import boxes as TB
from ubteacher_tpu_torch.ops import losses as TL
from ubteacher_tpu_torch.ops.kernels import focal_triton, giou_cuda, nms_cuda
from ubteacher_tpu_torch.ops.nms import batched_nms_keep, nms_keep, top_k_detections


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# focal
# --------------------------------------------------------------------------


@pytest.fixture
def one_torch_thread():
    """torch on one CPU thread for the test, the caller's count restored
    after. torch's first multi-threaded evaluation of the focal loss in a
    fresh process on a loaded machine has computed one intra-op worker's
    chunk of the elementwise ops up to 1.5e-4 off, beyond this test's
    tolerance; single-threaded it never did (port_tools/focal_first_call.py).
    The JAX side never moved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 1.5), (-1.0, 2.0)])
def test_focal_matches_jax_and_pallas(alpha, gamma, one_torch_thread):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(256, 80)) * 3).astype(np.float32)
    t = (rng.random((256, 80)) < 0.05).astype(np.float32)
    ref = JL.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(t), alpha, gamma)
    pal = sigmoid_focal_loss_pallas(jnp.asarray(x), jnp.asarray(t), alpha, gamma, True)
    xt = _t(x).requires_grad_(True)
    got = focal_triton.sigmoid_focal_loss(xt, _t(t), alpha, gamma)
    for want in (ref, pal):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)

    g = rng.random((256, 80)).astype(np.float32)
    gref = jax.grad(lambda xx: (JL.sigmoid_focal_loss(xx, jnp.asarray(t), alpha, gamma) * g).sum())(
        jnp.asarray(x))
    gpal = jax.grad(lambda xx: (sigmoid_focal_loss_pallas(
        xx, jnp.asarray(t), alpha, gamma, True) * g).sum())(jnp.asarray(x))
    (got * _t(g)).sum().backward()
    analytic = TL.sigmoid_focal_loss_grad(_t(x), _t(t), _t(g), alpha, gamma)
    for have in (xt.grad, analytic):
        for want in (gref, gpal):
            np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# GIoU / IoU family
# --------------------------------------------------------------------------


def _ltrb(rng, n):
    return (rng.random((n, 4)) * 10 + 0.5).astype(np.float32)


def test_giou_matches_jax_and_pallas():
    rng = np.random.default_rng(2)
    p, t, w = _ltrb(rng, 100), _ltrb(rng, 100), rng.random(100).astype(np.float32)
    ref = JL.iou_loss(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w), "giou")
    pal = giou_loss_pallas(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w), True)
    pt = _t(p).requires_grad_(True)
    got = giou_cuda.giou_loss(pt, _t(t), _t(w))
    for want in (ref, pal):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    gref = jax.grad(lambda pp: JL.iou_loss(pp, jnp.asarray(t), jnp.asarray(w), "giou"))(jnp.asarray(p))
    gpal = jax.grad(lambda pp: giou_loss_pallas(pp, jnp.asarray(t), jnp.asarray(w), True))(jnp.asarray(p))
    for want in (gref, gpal):
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_family_matches_jax(loss_type):
    rng = np.random.default_rng(3)
    p, t, w = _ltrb(rng, 64), _ltrb(rng, 64), rng.random(64).astype(np.float32)
    ref = JL.iou_loss(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w), loss_type)
    got = TL.iou_loss(_t(p), _t(t), _t(w), loss_type)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# --------------------------------------------------------------------------
# other losses and box ops
# --------------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    y = rng.normal(size=(50, 4)).astype(np.float32)
    s = rng.normal(size=(50, 4)).astype(np.float32)
    t01 = rng.random((50, 4)).astype(np.float32)
    w = rng.random(50).astype(np.float32)
    v = (rng.random(50) > 0.3).astype(np.float32)
    reg = (rng.random((50, 4)) * 5 + 0.1).astype(np.float32)
    cases = [
        (JL.bce_with_logits(jnp.asarray(x), jnp.asarray(t01)), TL.bce_with_logits(_t(x), _t(t01))),
        (JL.smooth_l1(jnp.asarray(x), jnp.asarray(y), 0.5), TL.smooth_l1(_t(x), _t(y), 0.5)),
        (JL.smooth_l1(jnp.asarray(x), jnp.asarray(y), 0.0), TL.smooth_l1(_t(x), _t(y), 0.0)),
        (JL.nl_loss(jnp.asarray(x), jnp.asarray(s), jnp.asarray(y), jnp.asarray(w), valid=jnp.asarray(v)),
         TL.nl_loss(_t(x), _t(s), _t(y), _t(w), valid=_t(v))),
        (JL.compute_ctrness_targets(jnp.asarray(reg)), TL.compute_ctrness_targets(_t(reg))),
        (JL.compute_iou_targets(jnp.asarray(reg), jnp.asarray(reg[::-1].copy())),
         TL.compute_iou_targets(_t(reg), _t(reg[::-1].copy()))),
    ]
    for method in ("weight_ctr_sum", "weight_ctr_mean", "sum", "mean"):
        cases.append((
            JL.kl_loss(jnp.asarray(x), jnp.asarray(s), jnp.asarray(y), weight=jnp.asarray(w),
                       loss_denorm=2.5, method=method, valid=jnp.asarray(v)),
            TL.kl_loss(_t(x), _t(s), _t(y), weight=_t(w), loss_denorm=2.5, method=method, valid=_t(v)),
        ))
    for i, (want, got) in enumerate(cases):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6, err_msg=str(i))


def test_box_ops_match_jax():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.random((20, 2)) * 50, rng.random((20, 2)) * 50 + 60], 1).astype(np.float32)
    b = np.concatenate([rng.random((30, 2)) * 50, rng.random((30, 2)) * 50 + 60], 1).astype(np.float32)
    locs = (rng.random((20, 2)) * 100).astype(np.float32)
    ltrb = (rng.random((20, 4)) * 30).astype(np.float32)
    hw = np.asarray([[40.0, 70.0], [64.0, 96.0]], np.float32)
    img = rng.random((2, 64, 96, 3)).astype(np.float32)
    pairs = [
        (JB.pairwise_iou(jnp.asarray(a), jnp.asarray(b)), TB.pairwise_iou(_t(a), _t(b))),
        (JB.matched_iou(jnp.asarray(a), jnp.asarray(b[:20])), TB.matched_iou(_t(a), _t(b[:20]))),
        (JB.decode_ltrb(jnp.asarray(locs), jnp.asarray(ltrb)), TB.decode_ltrb(_t(locs), _t(ltrb))),
        (JB.encode_ltrb(jnp.asarray(locs)[:, None], jnp.asarray(a)[None]),
         TB.encode_ltrb(_t(locs)[:, None], _t(a)[None])),
        (JB.clip_boxes(jnp.asarray(a), 70.0, 90.0),
         TB.clip_boxes(_t(a), torch.tensor(70.0), torch.tensor(90.0))),
        (JB.mask_canvas_padding(jnp.asarray(img), jnp.asarray(hw)),
         TB.mask_canvas_padding(_t(img), _t(hw))),
    ]
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6, err_msg=str(i))


# --------------------------------------------------------------------------
# NMS
# --------------------------------------------------------------------------


def _random_boxes(rng, n, size=200.0):
    xy = rng.random(size=(n, 2)) * size
    wh = rng.random(size=(n, 2)) * 50 + 1
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _iou_margin(boxes, t):
    """Smallest |IoU - t| over all pairs, in float64."""
    b = boxes.astype(np.float64)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = np.clip(np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    iou = inter / (area[:, None] + area[None, :] - inter)
    return np.abs(iou - t).min()


def _check_nms(boxes, scores, valid, t):
    assert _iou_margin(boxes, t) > 1e-5
    got = nms_keep(_t(boxes), _t(scores), _t(valid), t).numpy()
    ref = np.asarray(j_nms_keep(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), t))
    pal = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), t,
                                     interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("n", [64, 130])
def test_nms_matches_jax(n):
    rng = np.random.default_rng(0)
    _check_nms(_random_boxes(rng, n), rng.random(n).astype(np.float32), rng.random(n) > 0.2, 0.5)


@pytest.mark.parametrize("n_valid", [0, 1, 37, 130, 512])
def test_nms_valid_count(n_valid):
    rng = np.random.default_rng(7)
    n = 512
    boxes = _random_boxes(rng, n)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    _check_nms(boxes, rng.random(n).astype(np.float32), valid, 0.5)


def test_nms_staircase_chain():
    """Every box overlaps only its neighbours, so greedy keeps alternate
    boxes: the suppression chain is as deep as the candidate list."""
    n = 256
    x = np.arange(n, dtype=np.float32) * 12.0
    boxes = np.stack([x, np.zeros(n, np.float32), x + 100.0, np.full(n, 100.0, np.float32)], axis=1)
    scores = np.linspace(1.0, 0.01, n).astype(np.float32)
    _check_nms(boxes, scores, np.ones(n, bool), 0.7)
    assert int(nms_keep(_t(boxes), _t(scores), torch.ones(n, dtype=torch.bool), 0.7).sum()) == n // 2


def test_nms_per_image_counts():
    """One batched call: each image keeps its own valid count."""
    rng = np.random.default_rng(8)
    b, n = 3, 256
    boxes = np.stack([_random_boxes(rng, n) for _ in range(b)])
    scores = rng.random((b, n)).astype(np.float32)
    valid = np.zeros((b, n), bool)
    valid[0, :5] = True
    valid[1] = rng.random(n) > 0.5
    got = nms_keep(_t(boxes), _t(scores), _t(valid), 0.5).numpy()
    for i in range(b):
        ref = np.asarray(j_nms_keep(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                    jnp.asarray(valid[i]), 0.5))
        np.testing.assert_array_equal(got[i], ref, err_msg=f"image {i}")
    assert not got[2].any()


def test_batched_nms_and_top_k_match_jax():
    rng = np.random.default_rng(9)
    b, n = 2, 200
    boxes = np.stack([_random_boxes(rng, n) for _ in range(b)])
    scores = rng.random((b, n)).astype(np.float32)
    classes = rng.integers(0, 3, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) > 0.1
    keep = batched_nms_keep(_t(boxes), _t(scores), _t(classes).long(), _t(valid), 0.6)
    idx, mask = top_k_detections(keep, _t(scores), 50)
    for i in range(b):
        j_keep = j_batched_nms_keep(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                    jnp.asarray(classes[i]), jnp.asarray(valid[i]), 0.6)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(j_keep))
        j_idx, j_mask = j_top_k(j_keep, jnp.asarray(scores[i]), 50)
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(idx[i].numpy()[mask[i].numpy()],
                                      np.asarray(j_idx)[np.asarray(j_mask)])


def test_kernel_launchers_refuse_cpu_tensors():
    """On a CPU tensor the launchers raise; only the wrappers route CPU
    tensors to the plain versions, and no launch is counted."""
    x = torch.zeros((4, 80))
    before = (dict(focal_triton.LAUNCHES), dict(giou_cuda.LAUNCHES), dict(nms_cuda.LAUNCHES))
    with pytest.raises(ValueError):
        focal_triton.focal_forward_kernel(x, x, 0.25, 2.0)
    with pytest.raises(ValueError):
        giou_cuda.giou_rows_kernel(torch.ones((4, 4)), torch.ones((4, 4)), torch.ones(4))
    with pytest.raises(ValueError):
        nms_cuda.nms_sorted_keep_kernel(torch.zeros((1, 4, 4)), torch.zeros(1, dtype=torch.int32), 0.5)
    focal_triton.sigmoid_focal_loss(x, x)
    nms_keep(torch.zeros((4, 4)), torch.zeros(4), torch.ones(4, dtype=torch.bool), 0.5)
    assert (dict(focal_triton.LAUNCHES), dict(giou_cuda.LAUNCHES), dict(nms_cuda.LAUNCHES)) == before
