"""The port's inference export (ubteacher_tpu_torch/tools/export_inference.py)
and the torch.library ops it traces through (`ubt::nms_sorted_keep`,
`ubt::roi_align_forward`, `ubt::stem_conv_pool`), on the CPU at the small
test configurations of tests/torch_parity.py.

For both detectors (FCOS with the fused stem, TPU.STEM_MODE "pallas",
through the CLI; Faster R-CNN), export -> torch.export.save ->
torch.export.load -> call on
the same parameters and images equals the port's eager inference function
bitwise, and the JAX package's inference function within the evaluation
tests' tolerances (the kept sets and classes equal; FCOS boxes within
5e-3 px and scores within 1e-5, as tests/test_torch_evaluator.py holds
them; R-CNN boxes within 5e-3 px and scores within 1e-4 with rtol 1e-4, as
tests/test_torch_rcnn_ops.py holds them). The loaded program runs from
the saved file alone: the ops registered, no model built. torch.library's
opcheck (schema, autograd registration, fake tensor, AOT dispatch) passes
on each op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_evaluator import BATCHES, _compare_detections
from test_torch_rcnn_ops import DET_ATOL
from torch_parity import (  # noqa: F401 (few_torch_threads, tmp_budget: autouse fixtures)
    RCNN_CANVAS,
    SMALL_OPTS,
    few_torch_threads,
    jax_model_and_params,
    port_model,
    port_rcnn_model,
    rcnn_setup,
    small_cfgs,
    tmp_budget,
)
from ubteacher_tpu_torch.ops.kernels import nms_cuda, roi_align_cuda
from ubteacher_tpu_torch.tools import export_inference as export

CPU = torch.device("cpu")


def _round_trip(tmp_path, cfg, rcnn, images, hw):
    exported = export.export_program(cfg, rcnn, images.shape[0], tuple(images.shape[1:3]), CPU)
    path = str(tmp_path / "infer.pt2")
    assert export.save(exported, path) > 0
    return export.load(path)


def _assert_bitwise(got: dict, ref):
    assert set(got) == set(vars(ref))
    for k, v in vars(ref).items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_fcos_export_round_trip(tmp_path, capsys):
    """Through the CLI on the CPU, which also writes the JAX tool's JSON
    fields (device in place of platforms)."""
    import json

    from ubteacher_tpu.evaluation.evaluator import make_fcos_inference_fn as j_make

    jcfg, _ = small_cfgs(["TPU.STEM_MODE", "pallas_interpret"])
    _, tcfg = small_cfgs(["TPU.STEM_MODE", "pallas"])
    jmodel, params = jax_model_and_params(jcfg, seed=1, cls_bias=[0.5, -1.0, 0.0, -0.5])
    model = port_model(tcfg, params).eval()
    batch = BATCHES[0]
    images, hw = torch.from_numpy(batch["images"]), torch.from_numpy(batch["hw"])
    out = tmp_path / "fcos.pt2"
    meta = export.main(["--out", str(out), "--cpu", "--batch", str(images.shape[0]), "--canvas",
                        *map(str, images.shape[1:3]), "--opts", *SMALL_OPTS, "TPU.STEM_MODE", "pallas"])
    assert meta == json.loads((tmp_path / "fcos.pt2.json").read_text())
    assert meta == {"detector": "fcos", "batch": 2, "canvas": list(images.shape[1:3]), "device": "cpu",
                    "bytes": out.stat().st_size}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == meta
    got = export.load(str(out))(model.state_dict(), images, hw)
    with torch.inference_mode():
        ref = export.inference_fn(tcfg, False)(model, images, hw)
    _assert_bitwise(got, ref)
    j_ref = j_make(jcfg, jmodel)(jax.tree.map(jnp.asarray, params), jnp.asarray(batch["images"]),
                                 jnp.asarray(batch["hw"]))
    _compare_detections(type(ref)(**got), j_ref)


def test_rcnn_export_round_trip(tmp_path):
    from ubteacher_tpu.engine.rcnn_trainer import make_rcnn_inference_fn as j_make

    jcfg, tcfg, jmodel, params, jbatch, tbatch = rcnn_setup(RCNN_CANVAS)
    model = port_rcnn_model(tcfg, params).eval()
    hw = np.asarray([[64, 64], [56, 48]], np.float32)
    images = tbatch["images_unlabel_k"]
    program = _round_trip(tmp_path, tcfg, True, images, torch.from_numpy(hw))
    got = program(model.state_dict(), images, torch.from_numpy(hw))
    with torch.no_grad():
        ref = export.inference_fn(tcfg, True)(model, images, torch.from_numpy(hw))
    _assert_bitwise(got, ref)
    j_ref = j_make(jcfg, jmodel)(jax.tree.map(jnp.asarray, params), jbatch["images_unlabel_k"], jnp.asarray(hw))
    mask = np.asarray(j_ref.mask)
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    assert mask.sum() > 0
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(j_ref.classes))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(getattr(j_ref, k)), rtol=1e-4, atol=DET_ATOL[k],
                                   err_msg=k)


def _op_samples():
    g = torch.Generator().manual_seed(0)
    xy = torch.rand((2, 40, 2), generator=g) * 50
    sboxes = torch.cat([xy, xy + 5 + torch.rand((2, 40, 2), generator=g) * 20], -1)
    nvalid = torch.tensor([40, 17], dtype=torch.int32)
    feats = [torch.randn((2, 4, 32 // s, 48 // s), generator=g) for s in (1, 2)]
    rxy = torch.rand((6, 2), generator=g) * 20
    boxes = torch.cat([rxy, rxy + 4 + torch.rand((6, 2), generator=g) * 12], -1)
    level = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.int32)
    x = torch.rand((1, 21, 18, 3), generator=g) * 255
    kernel, scale, bias = torch.randn((7, 7, 3, 64), generator=g), torch.rand(64, generator=g), torch.randn(64)
    return {
        "nms_sorted_keep": (torch.ops.ubt.nms_sorted_keep, (sboxes, nvalid, 0.5)),
        "roi_align_forward": (torch.ops.ubt.roi_align_forward, (feats, boxes, level, 3, [1.0, 0.5], 7, 0)),
        "stem_conv_pool": (torch.ops.ubt.stem_conv_pool, (x, kernel, scale, bias, torch.bfloat16)),
    }


@pytest.mark.parametrize("name", ["nms_sorted_keep", "roi_align_forward", "stem_conv_pool"])
def test_opcheck(name):
    op, args = _op_samples()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_are_the_plain_versions_on_the_cpu():
    """On CPU tensors each op returns its plain version's bits, in a fresh
    tensor (no alias of an input)."""
    from ubteacher_tpu_torch.ops.stem import stem_conv_pool_plain

    samples = _op_samples()
    plain = {
        "nms_sorted_keep": nms_cuda.nms_sorted_keep_plain,
        "roi_align_forward": roi_align_cuda.roi_align_plain,
        "stem_conv_pool": stem_conv_pool_plain,
    }
    for name, (op, args) in samples.items():
        got, ref = op(*args), plain[name](*args)
        assert torch.equal(got, ref), name
        inputs = [t for a in args for t in (a if isinstance(a, list) else [a]) if isinstance(t, torch.Tensor)]
        assert all(got.untyped_storage().data_ptr() != t.untyped_storage().data_ptr() for t in inputs), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="the device rule without a card")
def test_export_needs_the_card_or_cpu(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA device"):
        export.main(["--out", str(tmp_path / "x.pt2")])
