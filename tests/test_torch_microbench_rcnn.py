"""The port's R-CNN stage microbenchmark
(ubteacher_tpu_torch/tools/microbench_rcnn.py) at a 128x128 canvas on the
CPU, where every stage runs its plain version: the stages' outputs against
the JAX package's functions on the same inputs (the tool draws them in the
JAX tool's order), and the tool end to end.

Tolerances: the anchors, the matcher's matched indices and labels (against
match_anchors_batched method="xla") and the NMS keep mask are integers or
exact box arithmetic, so bitwise; ROIAlign in float32 within 1e-5 (float32
sums of up to 8 x 8 bilinear samples in another order)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (few_torch_threads, tmp_budget: autouse fixtures)
    few_torch_threads,
    tmp_budget,
)
from ubteacher_tpu_torch.tools import microbench_rcnn as mb

CANVAS = (128, 128)
B, ROIS, CHANNELS = 2, 24, 8


@pytest.fixture(scope="module")
def setup():
    inputs = mb.make_inputs(B, CANVAS, rois=ROIS, channels=CHANNELS)
    runs = mb.stages(inputs, CANVAS, torch.device("cpu"), feat_dtype=torch.float32)
    return inputs, runs


def _jax_anchors():
    from ubteacher_tpu.modeling.anchors import generate_anchors

    return generate_anchors(CANVAS, mb.STRIDES, mb.SIZES, mb.RATIOS)


def test_matcher_equals_jax_xla(setup):
    from ubteacher_tpu.modeling.matcher import match_anchors_batched

    inputs, runs = setup
    anch = _jax_anchors()
    mi, labels = match_anchors_batched(anch["anchors"], jnp.asarray(inputs["gt_boxes"]),
                                       jnp.asarray(inputs["gt_mask"]), method="xla")
    for name in ("match_anchors_batched (dispatch)", "match_quality+match only"):
        t_mi, t_labels = runs[name]()
        np.testing.assert_array_equal(t_labels.numpy(), np.asarray(labels), err_msg=name)
        np.testing.assert_array_equal(t_mi.numpy(), np.asarray(mi), err_msg=name)
    assert (np.asarray(labels) == 1).any() and (np.asarray(labels) == 0).any()


def test_nms_keep_equals_jax(setup):
    import jax

    from ubteacher_tpu.ops.nms import batched_nms_keep

    inputs, runs = setup
    boxes, scores = jnp.asarray(inputs["cboxes"]), jnp.asarray(inputs["cscores"])
    lvls = jnp.zeros(scores.shape, jnp.int32)
    valid = jnp.ones(scores.shape, bool)
    ref = jax.vmap(lambda b_, s_, l_, v_: batched_nms_keep(b_, s_, l_, v_, 0.7))(boxes, scores, lvls, valid)
    got = runs[f"batched_nms_keep ({mb.CANDIDATES} cand)"]()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < got.numel()


def test_roi_align_equals_jax(setup):
    from ubteacher_tpu.ops.roi_align import multilevel_roi_align

    inputs, runs = setup
    pyramid = {f"p{i}": jnp.asarray(inputs[f"p{i}"]) for i in (2, 3, 4, 5)}
    ref = np.asarray(multilevel_roi_align(pyramid, jnp.asarray(inputs["rois"]), ("p2", "p3", "p4", "p5"), 7, 0))
    got = runs[f"roi_align fwd ({B}x{ROIS} rois)"]()
    assert got.shape == ref.shape == (B, ROIS, 7, 7, CHANNELS)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    grads = runs["roi_align fwd+bwd"]()
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


def test_anchors_equal_jax(setup):
    from ubteacher_tpu_torch.modeling.anchors import generate_anchors

    ref = _jax_anchors()
    got = generate_anchors(CANVAS, mb.STRIDES, mb.SIZES, mb.RATIOS, device="cpu")
    np.testing.assert_array_equal(got["anchors"].numpy(), np.asarray(ref["anchors"]))
    assert got["level_lengths"] == list(ref["level_lengths"])


def test_tool_end_to_end_on_the_cpu(capsys, monkeypatch):
    """At 8 rois an image and 4 channels (the plain ROIAlign takes seconds a
    call on the CPU at the tool's 512 x 256)."""
    monkeypatch.setattr(mb, "ROIS", 8)
    monkeypatch.setattr(mb, "CHANNELS", 4)
    out = mb.main(["--cpu", "--iters", "1", "--trials", "1", "--batch", "1", "--canvas", *map(str, CANVAS)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    names = ["label_anchors (matcher+sample)", "match_quality+match only", "match_anchors_batched (dispatch)",
             "find_top_proposals", "roi_align fwd (2x8 rois)", "roi_align fwd+bwd", "batched_nms_keep (2000 cand)"]
    assert list(out["rows"]) == names
    for name in names:
        assert any(line.startswith(name) for line in lines[1:-1]), name
        assert out["rows"][name]["min_ms"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the device rule without a card")
def test_needs_the_card_or_cpu():
    with pytest.raises(SystemExit, match="no CUDA device"):
        mb.main(["--iters", "1"])
