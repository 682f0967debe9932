"""The port's measuring tools (ubteacher_tpu_torch/tools/): the FLOP count
of mfu.py against a hand count from the convolutions' and matmuls' shapes
and its analytic cross-check against the JAX tool's; profile_step.py's
grouping of profiler rows; parity_eval.py against `train_net --eval-only`
on one synthetic COCO root and reference-format checkpoint; ab_stem.py's
stem marking; and the device rule: without a card every tool stops unless
--cpu is given, and ab_stem, which only measures, stops either way."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from test_cli import _write_coco_root
from test_full_checkpoint_convert import _synthetic_reference_state
from test_torch_cli import CONFIG, _opts
from torch_parity import (  # noqa: F401 (fixtures: autouse, or named in usefixtures)
    RCNN_SMALL_OPTS,
    SMALL_OPTS,
    few_torch_threads,
    large_files_removed,
    tmp_budget,
)
from ubteacher_tpu_torch import train_net
from ubteacher_tpu_torch.data.coco import generate_supervision_seed_file
from ubteacher_tpu_torch.tools import ab_stem, learning_sanity, mfu, parity_eval, profile_step
from ubteacher_tpu_torch.tools.common import step_setup

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import mfu as jax_mfu  # noqa: E402  (the repo root on sys.path first)

CPU = torch.device("cpu")


def _hand_count(calls) -> int:
    """2 x MAC of every recorded Conv2d / Linear call, from its shapes; in
    a call made with grad on, the backward adds one forward's count for the
    input's gradient (where the input needs one) and one for the weight's
    (where the weight needs one), as autograd's convolution_backward and mm
    compute them."""
    total = 0
    for m, in_shape, in_grad, out_shape, grad_on in calls:
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            f = 2 * out_shape.numel() * (m.in_channels // m.groups) * kh * kw
        else:
            f = 2 * in_shape[:-1].numel() * m.in_features * m.out_features
        total += f
        if grad_on:
            total += f * in_grad + f * m.weight.requires_grad
    return total


@pytest.mark.parametrize("rcnn", [False, True], ids=["fcos", "rcnn"])
def test_flop_count_equals_a_hand_count(rcnn):
    """One mutual step of the small CPU configs (teacher forward, student
    forward and backward; frozen stem and res2): FlopCounterMode's count
    equals the hand count exactly (integers; tolerance 0)."""
    opts = (RCNN_SMALL_OPTS if rcnn else SMALL_OPTS) + ["TPU.ORACLE_PSEUDO", "False"]
    _, (burnin, mutual), state, batch = step_setup(rcnn, CPU, batch=2, canvas=(64, 64) if rcnn else (64, 96),
                                                   opts=opts)
    state, _ = burnin(state, batch)
    state, _ = mutual(state, batch)
    calls = []

    def hook(m, inp, out):
        calls.append((m, inp[0].shape, inp[0].requires_grad, out.shape, torch.is_grad_enabled()))

    handles = [m.register_forward_hook(hook) for model in (state.student, state.teacher)
               for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        flops, state, by_op = mfu.count_step_flops(mutual, state, batch)
    finally:
        for h in handles:
            h.remove()
    assert flops == _hand_count(calls) == sum(by_op.values())
    assert by_op["aten.convolution_backward"] > 0  # the student's backward was counted
    if rcnn:  # the box head's fully connected layers
        assert {"aten.mm", "aten.addmm"} <= set(by_op)
    else:
        assert set(by_op) == {"aten.convolution", "aten.convolution_backward"}


@pytest.mark.parametrize("rcnn", [False, True], ids=["fcos", "rcnn"])
@pytest.mark.parametrize("canvas,batch", [((768, 1344), 8), ((800, 1333), 2), ((64, 96), 1)])
def test_analytic_estimate_equals_the_jax_tools(canvas, batch, rcnn):
    assert mfu.analytic_estimate(canvas, batch, rcnn) == jax_mfu.analytic_estimate(canvas, batch, rcnn)


def test_peak_by_device_name():
    from ubteacher_tpu_torch.tools.common import peak_bf16

    assert peak_bf16("NVIDIA H100 80GB HBM3") == ("H100 SXM", 989e12)
    assert peak_bf16("NVIDIA H100 PCIe") == ("H100 PCIe", 756e12)


def test_profile_grouping_of_synthetic_rows():
    rows = [
        (9.84, 2.0, "void roi_align_forward_kernel<__nv_bfloat16>(...)"),
        (4.15, 1.0, "roi_align_backward_tile"),
        (0.34, 3.0, "nms_mask_kernel"), (0.1, 3.0, "nms_sweep_kernel"),
        (0.2, 1.0, "match_anchors_kernel"), (0.05, 4.0, "scatter_rows_kernel"),
        (0.012, 2.0, "giou_fwd"), (0.389, 4.0, "_focal_fwd_kernel"),
        (0.28, 2.0, "stem_conv_pool_mma"),
        (30.0, 100.0, "sm90_xmma_fprop_implicit_gemm_bf16"), (10.0, 40.0, "cutlass_80_tensorop_s1688gemm"),
        (5.0, 20.0, "nvjet_tst_128x64"), (2.0, 30.0, "Memcpy DtoD (Device -> Device)"),
        (1.0, 10.0, "Memset (Device)"), (0.5, 6.0, "DeviceRadixSortOnesweepKernel"),
        (3.0, 50.0, "void at::native::reduce_kernel<512, 1>"), (4.0, 8.0, "upsample_nearest2d_out_frame"),
        (6.0, 60.0, "void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>"),
        (2.5, 25.0, "void at::native::index_elementwise_kernel"),
        (50.0, 900.0, "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>"),
        (0.7, 3.0, "some_kernel_of_no_group"),
    ]
    groups = profile_step.group_rows(rows)
    want = {
        "ROIAlign forward": (9.84, 2.0), "ROIAlign backward": (4.15, 1.0), "NMS": (0.44, 6.0),
        "matcher": (0.2, 1.0), "row scatter": (0.05, 4.0), "GIoU": (0.012, 2.0), "focal": (0.389, 4.0),
        "stem": (0.28, 2.0), "convolutions (cuDNN)": (40.0, 140.0), "matmuls": (5.0, 20.0),
        "memcpy, memset": (3.0, 40.0), "sorts": (0.5, 6.0), "reductions": (3.0, 50.0),
        "upsample, max-pool": (4.0, 8.0), "copies and casts": (6.0, 60.0),
        "gather, scatter, index, cat": (2.5, 25.0), "elementwise": (50.0, 900.0), "other": (0.7, 3.0),
    }
    assert groups.keys() == want.keys()
    for g, (ms, calls) in want.items():
        assert groups[g][0] == pytest.approx(ms, rel=1e-12) and groups[g][1] == calls, g
    # every row lands in exactly one group: the sums are kept
    assert sum(ms for ms, _ in groups.values()) == pytest.approx(sum(r[0] for r in rows), rel=1e-12)


def test_device_rows_take_the_devices_rows_per_step():
    from torch.autograd import DeviceType

    def ev(key, device_type, self_device_us, count, self_cpu_us=0.0, annotation=False):
        return types.SimpleNamespace(key=key, device_type=device_type, self_device_time_total=self_device_us,
                                     count=count, self_cpu_time_total=self_cpu_us, is_user_annotation=annotation)

    prof = types.SimpleNamespace(key_averages=lambda: [
        ev("aten::conv2d", DeviceType.CPU, 3000.0, 6, 900.0),  # an op's row repeats its kernels: left out
        ev("xmma_fprop", DeviceType.CUDA, 3000.0, 6), ev("Memset (Device)", DeviceType.CUDA, 30.0, 3),
        ev("idle_kernel", DeviceType.CUDA, 0.0, 3),
        # a span over the kernels on the device's timeline: left out
        ev("ubt.step.graph_replay", DeviceType.CUDA, 3030.0, 3, annotation=True),
    ])
    assert profile_step.device_rows(prof, 3) == [(1.0, 2.0, "xmma_fprop"), (0.01, 1.0, "Memset (Device)")]
    assert profile_step.device_rows(prof, 3, on_device=False) == [(0.3, 2.0, "aten::conv2d")]


def test_profile_step_runs_on_the_cpu_and_keeps_the_trace(tmp_path, capsys):
    out = tmp_path / "trace.json"
    lines = profile_step.main(["--cpu", "--batch", "1", "--canvas", "64", "96", "--steps", "1", "--out", str(out),
                               "--opts"] + SMALL_OPTS)
    assert "CPU ops' own time" in lines[0] and "device busy" not in lines[0]
    assert out.stat().st_size > 0 and lines == capsys.readouterr().out.strip().splitlines()[1:]


def test_ab_stem_marks_the_stem_without_changing_the_model():
    from torch.profiler import ProfilerActivity, profile

    from ubteacher_tpu_torch.tools.common import build_fcos_model, load_cfg

    cfg = load_cfg(SMALL_OPTS)
    model = build_fcos_model(cfg, CPU, seed=0, cls_bias=0.5).eval()
    x = torch.rand((1, 3, 64, 96), generator=torch.Generator().manual_seed(0)) * 255
    with torch.no_grad():
        before = model.backbone(x)
        ab_stem.mark_stems(model)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            after = model.backbone(x)
    assert before.keys() == after.keys() and all(torch.equal(before[k], after[k]) for k in before)
    assert sum(e.name == ab_stem.STEM_RANGE for e in prof.events()) == 1
    assert ab_stem.range_kernels(prof, ab_stem.STEM_RANGE, 1) == {}  # no device kernels on the CPU


def test_ab_stem_leaves_out_windows_that_lost_rows():
    """H100 windows of one turn: launches vary by a few kernels (kept); a
    window with half its rows lost reads half the busy time (left out)."""
    windows = [{"busy_ms": 256.3, "launches": 5623}, {"busy_ms": 255.9, "launches": 5622},
               {"busy_ms": 113.8, "launches": 2790}]
    assert ab_stem.best_window(windows) == windows[1]
    assert ab_stem.best_window(windows[:1]) == windows[0]


@pytest.mark.usefixtures("large_files_removed")
def test_parity_eval_gives_the_eval_only_results(tmp_path, monkeypatch):
    """A reference-format EnsembleTSModel .pth on a synthetic COCO root:
    parity_eval's AP table equals `train_net --eval-only MODEL.WEIGHTS`'s
    (the teacher), field for field (the same weights, images and batches on
    the CPU: exact); and the student's differs."""
    root = tmp_path / "coco"
    _write_coco_root(root, size=48)
    generate_supervision_seed_file(str(tmp_path / "seed.txt"), num_images=8, percents=(50.0,), seeds=1)
    monkeypatch.setenv("COCO_ROOT", str(root))
    rng = np.random.default_rng(3)
    sd_t = _synthetic_reference_state(18, 1, 4 * 17, rng)
    sd_s = _synthetic_reference_state(18, 1, 4 * 17, rng)
    ensemble = {f"modelTeacher.{k}": torch.from_numpy(v) for k, v in sd_t.items()}
    ensemble.update({f"modelStudent.module.{k}": torch.from_numpy(v) for k, v in sd_s.items()})
    ckpt = tmp_path / "ensemble.pth"
    torch.save({"model": ensemble}, str(ckpt))
    opts = _opts(tmp_path, tmp_path / "out", str(ckpt))

    want = train_net.main(train_net.default_argument_parser().parse_args(["--config", CONFIG, "--eval-only"] + opts))
    common = ["--checkpoint", str(ckpt), "--config", CONFIG, "--coco-root", str(root), "--cpu",
              "--eval-batch", "8"]
    got = parity_eval.main(common + opts)
    timing = "inference_sec_per_image"
    assert {k for k in got if k != timing} == {k for k in want if k != timing} and "AP" in got
    for k in want:
        if k != timing:
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k

    # --model student takes the other half of the ensemble, every parameter
    from ubteacher_tpu_torch.checkpoint.torch_weights import convert_ubt_fcos_model
    from ubteacher_tpu_torch.tools.common import load_cfg

    cfg = load_cfg(opts, CONFIG)
    student = parity_eval.load_detector(cfg, str(ckpt), "student", CPU).state_dict()
    for k, v in convert_ubt_fcos_model(sd_s, 18).items():
        assert torch.equal(student[k], torch.from_numpy(np.asarray(v)).to(student[k].dtype).reshape(student[k].shape)), k
    assert parity_eval.main(common + ["--model", "student"] + opts).keys() == got.keys()

    # --limit takes the first N images
    limited = parity_eval.main(common + ["--limit", "2"] + opts)
    assert "AP" in limited


@pytest.mark.parametrize("tool,argv", [
    (learning_sanity, ["--ablation", "--steps", "2", "--burnin", "1"]),
    (mfu, ["--families", "fcos"]),
    (profile_step, []),
    (parity_eval, ["--checkpoint", "missing.pth"]),
    (ab_stem, []),
], ids=["learning_sanity", "mfu", "profile_step", "parity_eval", "ab_stem"])
def test_no_card_stops_the_tool(tool, argv, monkeypatch, capsys):
    """Without a card a tool stops with a clear error rather than carrying
    on on the CPU; ab_stem, which only measures, has no CPU mode."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        tool.main(argv)
    assert "no CUDA device" in str(err.value)
    if tool is ab_stem:
        with pytest.raises(SystemExit):
            tool.main(["--cpu"])
        assert "unrecognized arguments: --cpu" in capsys.readouterr().err
