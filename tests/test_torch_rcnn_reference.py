"""The port's Faster R-CNN steps against the benchmark's plain float32
reference (benchmark/reference/ubtref, which imports nothing of the port),
on the CPU at a small size: R-18, 64 x 96 canvases, 2 + 2 images, float32,
seeded random weights from the R-CNN configuration's init table.

The reference replays the port's discrete choices (the proposals' ranking,
the matchers' labels, the inference ranking, the pseudo-label threshold;
benchmark/reference/ubtref/engine/replay.py), as the benchmark's R-CNN cell
does on the card: both sides then differ only in the order of float32 sums
(the reference's ROIAlign contracts separable weights where the port's CPU
path gathers the four taps), so the losses, every leaf's gradient and the
EMA teacher agree to 1e-4 of their size and no choice is refused. Also the
reference's plain ROIAlign, anchor matcher and row scatter against the
port's CPU paths."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import cfgs, compare, manifest, weights as weights_mod  # noqa: E402  (the repo root first)
from benchmark.harness.rcnn_train_cell import Recording  # noqa: E402

CONFIG = "rcnn_r50_fpn_coco_sup1"
SMALL = {"MODEL.RESNETS.DEPTH": 18, "TPU.CANVAS_LANDSCAPE": [64, 96], "TPU.CANVAS_PORTRAIT": [96, 64],
         "TPU.EXTRA_TRAIN_CANVASES": [], "TPU.TEST_CANVAS": [64, 96], "TPU.MAX_GT": 8, "TPU.MAX_PSEUDO": 20,
         "TPU.NMS_CANDIDATES": 100, "SOLVER.IMG_PER_BATCH_LABEL": 2, "SOLVER.IMG_PER_BATCH_UNLABEL": 2,
         "TPU.COMPUTE_DTYPE": "float32", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32,
         "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.PRE_NMS_TOPK_TEST": 100,
         "MODEL.RPN.POST_NMS_TOPK_TRAIN": 64, "MODEL.RPN.POST_NMS_TOPK_TEST": 64, "TEST.DETECTIONS_PER_IMAGE": 20,
         "SEED": 3}
# float32 on both sides and the same choices: only the order of sums differs
RTOL = 1e-4


def _batch(structures, seed: int):
    """One mutual batch (2 + 2 images at 64 x 96, three boxes an image) in a
    package's structures."""
    g = torch.Generator().manual_seed(seed)
    b, m = 2, 8
    xy = torch.rand((b, m, 2), generator=g) * torch.tensor([60.0, 30.0])
    wh = 12 + torch.rand((b, m, 2), generator=g) * 24
    mask = torch.zeros((b, m), dtype=torch.bool)
    mask[:, :3] = True
    gt = structures.PaddedInstances(
        boxes=torch.cat([xy, xy + wh], -1), classes=torch.randint(0, 80, (b, m), generator=g),
        scores=torch.ones((b, m)), box_std=torch.zeros((b, m, 4)), mask=mask)
    hw = torch.tensor([[64.0, 96.0], [60.0, 90.0]])
    return {"images_label_k": torch.randint(0, 256, (b, 64, 96, 3), generator=g, dtype=torch.uint8),
            "gt_label": gt, "label_hw": hw,
            "images_unlabel_k": torch.randint(0, 256, (b, 64, 96, 3), generator=g, dtype=torch.uint8),
            "unlabel_hw": hw}


def _three_steps(side, conf, step_index=None):
    """(per-step metrics, readings) of burn-in, the boundary and one EMA
    mutual step of a package (`side`: its config, structures, model builder,
    optimizer builder, state and steps) from the configuration's seeded
    weights; step_index[0] is set to the step under way."""
    cfg = cfgs.build(side["config"], conf["cfg"], SMALL)
    model = side["build"](cfg, "cpu", torch.Generator().manual_seed(0))
    w0 = weights_mod.make_weights(weights_mod.param_shapes(model), conf["init"], 5, torch.device("cpu"))
    weights_mod.load_into(model, w0)
    state = side["state"].create(model, side["optimizer"](cfg, model))
    burnin, mutual = side["steps"](cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    rng = torch.Generator().manual_seed(7)
    out = {"losses": [], "first_losses": {}, "grad": {}}
    metrics = []
    for i, step in enumerate((burnin, mutual, mutual)):
        if step_index is not None:
            step_index[0] = i
        state, m = step(state, dict(_batch(side["structures"], 20 + i), rng=rng))
        metrics.append({k: float(v) for k, v in m.items()})
        out["losses"].append(metrics[-1]["total_loss"])
        if i == 0:
            out["first_losses"] = {k: v for k, v in metrics[-1].items() if k.startswith("loss_")}
            out["grad"] = compare.to_host(compare.first_gradient_norms(state, names, w0))
    out["change"] = compare.to_host(compare.change_norms(state.student, w0))
    out["teacher"] = compare.to_host(compare.change_norms(state.teacher, w0, out["change"]))
    return metrics, out


@pytest.fixture(scope="module")
def runs():
    from benchmark.reference.ubtref import config as ref_config, solver as ref_solver, structures as ref_structures
    from benchmark.reference.ubtref.engine import fcos_trainer as ref_fcos, rcnn_trainer as ref_rcnn
    from benchmark.reference.ubtref.engine.replay import Choices
    from benchmark.reference.ubtref.modeling import rcnn as ref_model
    from ubteacher_tpu_torch import config as port_config, solver as port_solver, structures as port_structures
    from ubteacher_tpu_torch.engine import fcos_trainer as port_fcos, rcnn_trainer as port_rcnn
    from ubteacher_tpu_torch.modeling import rcnn as port_model

    torch.set_num_threads(2)
    conf = manifest.config(CONFIG)
    step = [None]
    port_side = {"config": port_config, "structures": port_structures, "build": port_model.build_two_stage_rcnn,
                 "optimizer": port_solver.build_optimizer, "state": port_fcos.FCOSTrainState,
                 "steps": port_rcnn.make_rcnn_train_steps}
    with Recording(lambda: (step[0], False)) as rec:
        port = _three_steps(port_side, conf, step)
    choices = Choices(rec.choices)
    ref_side = {"config": ref_config, "structures": ref_structures, "build": ref_model.build_two_stage_rcnn,
                "optimizer": ref_solver.build_optimizer, "state": ref_fcos.FCOSTrainState,
                "steps": lambda cfg: ref_rcnn.make_rcnn_train_steps(cfg, choices)}
    ref = _three_steps(ref_side, conf)
    return port, ref, choices


def test_the_reference_takes_every_choice_of_the_port(runs):
    _, _, choices = runs
    counts = choices.counts()
    assert [counts[f"replay.step{i}.refused"] for i in range(3)] == [0, 0, 0], counts
    assert all(counts[f"replay.step{i}.taken"] > 0 for i in range(3))


def test_losses_of_burn_in_boundary_and_ema_steps_match(runs):
    (port_metrics, _), (ref_metrics, _), _ = runs
    for i, (p, r) in enumerate(zip(port_metrics, ref_metrics)):
        assert set(r) <= set(p)
        for k, v in r.items():
            np.testing.assert_allclose(p[k], v, rtol=RTOL, atol=1e-6, err_msg=f"step {i} {k}")
    assert port_metrics[1]["num_pseudo"] > 0 and port_metrics[2]["loss_cls_pseudo"] > 0


def test_each_leaf_of_the_gradient_student_and_teacher_match(runs):
    (_, port), (_, ref), _ = runs
    numbers = compare.readings(port, ref)
    for key in ("first_loss_gap", "grad_gap", "change_gap", "teacher_gap"):
        assert numbers[key] < RTOL, (key, numbers)
    assert min(ref["teacher"].values()) >= 0 and max(ref["teacher"].values()) > 0


def _pyramid(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((2, 8, 16 // 2**i, 24 // 2**i), generator=g, requires_grad=True) for i in range(4)]


def test_plain_roi_align_forward_and_backward_match_the_ports_cpu_path():
    from benchmark.reference.ubtref.ops.roi_align import multilevel_roi_align as ref_roi_align
    from ubteacher_tpu_torch.ops.roi_align import multilevel_roi_align as port_roi_align

    g = torch.Generator().manual_seed(1)
    xy = torch.rand((2, 12, 2), generator=g) * torch.tensor([90.0, 60.0]) - 4
    boxes = torch.cat([xy, xy + 1 + torch.rand((2, 12, 2), generator=g) * 80], -1)
    cot = torch.randn((2, 12, 7, 7, 8), generator=g)
    outs = []
    for fn in (port_roi_align, ref_roi_align):
        feats = _pyramid(2)
        out = fn(feats, boxes)
        (out * cot).sum().backward()
        # a level no roi is assigned to gets no gradient from autograd (None)
        outs.append((out.detach(), [torch.zeros_like(f) if f.grad is None else f.grad for f in feats]))
    (p, pg), (r, rg) = outs
    torch.testing.assert_close(r, p, rtol=1e-5, atol=1e-5)
    for a, b in zip(rg, pg):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_plain_anchor_matcher_equals_the_ports_cpu_path():
    from benchmark.reference.ubtref.modeling.anchors import generate_anchors
    from benchmark.reference.ubtref.modeling.matcher import match_anchors_batched as ref_match
    from ubteacher_tpu_torch.modeling.matcher import match_anchors_batched as port_match

    anchors = generate_anchors((64, 96), [4, 8, 16, 32, 64], [[32], [64], [128], [256], [512]], [[0.5, 1.0, 2.0]],
                               0.0, "cpu")["anchors"]
    from ubteacher_tpu_torch import structures

    gt = _batch(structures, 4)["gt_label"]
    gt.mask[1] = False  # an image with no valid gt
    for a, b in zip(port_match(anchors, gt.boxes, gt.mask), ref_match(anchors, gt.boxes, gt.mask)):
        assert torch.equal(a, b)


def test_plain_row_gather_scatters_the_gradient_as_the_ports_row_scatter():
    from benchmark.reference.ubtref.ops.row_gather import take_rows as ref_take
    from ubteacher_tpu_torch.ops.row_gather import take_rows as port_take

    g = torch.Generator().manual_seed(3)
    rows = torch.randint(0, 10, (2, 30), generator=g)  # duplicates accumulate
    cot = torch.randn((2, 30, 5), generator=g)
    grads = []
    for fn in (port_take, ref_take):
        x = torch.randn((2, 10, 5), generator=torch.Generator().manual_seed(4), requires_grad=True)
        (fn(x, rows) * cot).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)
