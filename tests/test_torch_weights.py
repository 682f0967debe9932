"""Reference-format weights loaded straight into the port's modules, against
ubteacher_tpu's converters followed by params_from_jax, bitwise.

Synthetic detectron2 / Caffe2 state dicts carry random arrays under the
names and shapes the JAX converters read, with random FrozenBN statistics so
that the fold (scale = gamma / sqrt(var + eps), bias = beta - mean * scale)
is exercised. The port keeps torch's layouts (conv OIHW, Linear (out, in));
the JAX path transposes to flax and params_from_jax transposes back, so any
layout slip on the port's side (a transpose too many, a wrong fc1
permutation) breaks the equality.
"""

import pickle

import numpy as np
import pytest
import torch

from test_full_checkpoint_convert import _synthetic_rcnn_reference_state, _synthetic_reference_state
from test_weights import _synthetic_c2_dict
from torch_parity import small_cfgs, small_rcnn_cfgs
from ubteacher_tpu.checkpoint import torch_weights as jw
from ubteacher_tpu_torch.checkpoint import params_from_jax
from ubteacher_tpu_torch.checkpoint import torch_weights as tw

DEPTH = 18


def _randomize(sd, rng):
    """Random values in every array of the synthetic dict (running_var
    positive), so that biases, GroupNorm, FrozenBN and scales all differ."""
    out = {}
    for k, v in sd.items():
        r = rng.normal(size=v.shape).astype(np.float32)
        out[k] = np.abs(r) + 0.5 if k.endswith("running_var") else r * 0.1
    return out


def _fcos_model(num_classes):
    from ubteacher_tpu_torch.modeling.fcos_head import build_one_stage_detector

    _, tcfg = small_cfgs(["MODEL.FCOS.NUM_CLASSES", str(num_classes)])
    return build_one_stage_detector(tcfg, device="cpu")


def _rcnn_model(num_classes):
    from ubteacher_tpu_torch.modeling.rcnn import build_two_stage_rcnn

    _, tcfg = small_rcnn_cfgs(["MODEL.ROI_HEADS.NUM_CLASSES", str(num_classes)])
    return build_two_stage_rcnn(tcfg, device="cpu")


def _assert_bitwise(model, ref):
    got = model.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def _load(model, converted):
    missing, unexpected = model.load_state_dict(tw.cast_like(converted, model.state_dict()), strict=True)
    assert not missing and not unexpected


def test_fcos_model_equals_jax_converter_then_params_from_jax():
    sd = _randomize(_synthetic_reference_state(DEPTH, 4, 4 * 17, np.random.default_rng(0)),
                    np.random.default_rng(1))
    ref = params_from_jax(jw.convert_ubt_fcos_model(sd, DEPTH))
    tracked = tw.TrackingStateDict(sd)
    model = _fcos_model(4)
    _load(model, tw.convert_ubt_fcos_model(tracked, DEPTH))
    assert tracked.unused() == []
    _assert_bitwise(model, ref)


def test_rcnn_model_equals_jax_converter_then_params_from_jax():
    sd = _randomize(_synthetic_rcnn_reference_state(DEPTH, 3, np.random.default_rng(2)),
                    np.random.default_rng(3))
    ref = params_from_jax(jw.convert_ubt_rcnn_model(sd, DEPTH, 7))
    tracked = tw.TrackingStateDict(sd)
    model = _rcnn_model(3)
    _load(model, tw.convert_ubt_rcnn_model(tracked, DEPTH, 7))
    assert tracked.unused() == []
    _assert_bitwise(model, ref)


def test_fc1_takes_channel_major_features():
    """The converted fc1 on the port's (P, P, C)-flattened ROI features
    equals torch's Linear on (C, P, P)-flattened ones."""
    rng = np.random.default_rng(4)
    c, p, d = 8, 7, 16
    sd = _synthetic_rcnn_reference_state(DEPTH, 3, rng)
    sd["roi_heads.box_head.fc1.weight"] = rng.normal(size=(d, c * p * p)).astype(np.float32)
    sd["roi_heads.box_head.fc1.bias"] = rng.normal(size=(d,)).astype(np.float32)
    conv = tw.convert_ubt_rcnn_model(sd, DEPTH, p)
    feat = torch.from_numpy(rng.normal(size=(c, p, p)).astype(np.float32))
    ref = torch.nn.functional.linear(feat.reshape(-1), torch.from_numpy(sd["roi_heads.box_head.fc1.weight"]),
                                     torch.from_numpy(sd["roi_heads.box_head.fc1.bias"]))
    ours = torch.nn.functional.linear(feat.permute(1, 2, 0).reshape(-1),
                                      torch.from_numpy(conv["box_head.fc1.weight"]),
                                      torch.from_numpy(conv["box_head.fc1.bias"]))
    torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-5)


def test_unused_keys_are_reported():
    sd = dict(_synthetic_reference_state(DEPTH, 4, 4 * 17, np.random.default_rng(5)))
    sd["proposal_generator.fcos_head.extra_conv.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    sd["backbone.bottom_up.res2.0.conv1.norm.num_batches_tracked"] = np.zeros((), np.int64)
    j, t = jw.TrackingStateDict(sd), tw.TrackingStateDict(sd)
    jw.convert_ubt_fcos_model(j, DEPTH)
    tw.convert_ubt_fcos_model(t, DEPTH)
    assert t.unused() == j.unused() == sorted(["proposal_generator.fcos_head.extra_conv.weight",
                                               "backbone.bottom_up.res2.0.conv1.norm.num_batches_tracked"])
    assert t.unused(ignore_substrings=("num_batches",)) == ["proposal_generator.fcos_head.extra_conv.weight"]


def test_cast_like_names_what_is_missing():
    model = _fcos_model(4)
    converted = tw.convert_ubt_fcos_model(_synthetic_reference_state(DEPTH, 4, 4 * 17, np.random.default_rng(6)),
                                          DEPTH)
    del converted["head.scales"]
    with pytest.raises(ValueError, match="head.scales"):
        tw.cast_like(converted, model.state_dict())


def test_split_ensemble_state_matches_jax():
    rng = np.random.default_rng(7)
    sd = {
        "modelTeacher.backbone.stem.conv1.weight": rng.normal(size=3),
        "modelStudent.module.backbone.stem.conv1.weight": rng.normal(size=3),
        "modelStudent.proposal_generator.fcos_head.cls_logits.bias": rng.normal(size=2),
        "iteration": np.asarray(5),
    }
    got, ref = tw.split_ensemble_state(sd), jw.split_ensemble_state(sd)
    assert {k: list(v) for k, v in got.items()} == {k: list(v) for k, v in ref.items()}
    assert list(got["student"]) == ["backbone.stem.conv1.weight", "proposal_generator.fcos_head.cls_logits.bias"]
    for part in ("teacher", "student"):
        for k in got[part]:
            assert got[part][k] is ref[part][k]


@pytest.mark.parametrize("fmt", ["c2", "d2"])
def test_pretrained_backbone_pickle(tmp_path, fmt):
    """load_c2_pickle + load_pretrained_backbone on a Caffe2 (AffineChannel)
    or detectron2 (FrozenBN statistics) pickle: the backbone equals JAX's
    converter followed by params_from_jax bitwise, nothing else moves."""
    if fmt == "c2":
        weights = _randomize(_synthetic_c2_dict(DEPTH, np.random.default_rng(8)), np.random.default_rng(9))
        ref_tree = jw.convert_c2_resnet(weights, DEPTH)
        payload = dict(weights)
    else:
        sd = _randomize(_synthetic_reference_state(DEPTH, 4, 4 * 17, np.random.default_rng(10)),
                        np.random.default_rng(11))
        weights = {k: v for k, v in sd.items() if k.startswith("backbone.bottom_up.")}
        ref_tree = jw.convert_d2_resnet(weights, DEPTH)
        payload = {"model": weights, "__author__": "synthetic"}
    path = tmp_path / f"{fmt}.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    assert set(tw.load_c2_pickle(str(path))) == set(weights)

    model = _fcos_model(4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tw.load_pretrained_backbone(model, str(path), DEPTH)
    ref = params_from_jax({"backbone": ref_tree})
    got = model.state_dict()
    for k, v in got.items():
        if k in ref:
            assert torch.equal(v, ref[k]), k
        else:
            assert torch.equal(v, before[k]), k
    assert len(ref) == len([k for k in got if k.startswith("backbone.")])


def test_load_torch_state_dict_formats(tmp_path):
    """.pth ({"model": sd} of tensors) and .pkl (numpy) read as numpy."""
    sd = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3), "b.bias": np.ones(2, np.float32)}
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 3}, tmp_path / "x.pth")
    with open(tmp_path / "x.pkl", "wb") as f:
        pickle.dump({"model": sd}, f)
    for name in ("x.pth", "x.pkl"):
        got = tw.load_torch_state_dict(str(tmp_path / name))
        ref = jw.load_torch_state_dict(str(tmp_path / name))
        assert set(got) == set(ref) == set(sd)
        for k in sd:
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], ref[k])
