"""The R-CNN cell's decision replay (reference/ubtref/engine/replay.py),
driven at a small size on the CPU: the float32 reference that replays its
own choices reads gaps of 0 and refuses nothing; the samplers' draws follow
the proposals where the lists differ; a program broken in how it
chooses has sets refused and reads beyond a limit, once for each fault: its
RPN NMS keeping the lowest-scoring proposals, its pseudo labels those of the
next image, its anchor labels shifted by one anchor. On the card, the cell's
control (the float32 reference against its float8 self) comes out not
correct."""

import pytest
import torch

import ubteacher_tpu_torch.engine.rcnn_trainer as rcnn_trainer
import ubteacher_tpu_torch.modeling.rpn as rpn
from benchmark.harness import compare, manifest, rcnn_refrun, traffic as traffic_mod
from benchmark.tests import small

WORKLOAD = "rcnn_mutual_recipe"
# small.CFG, and the R-CNN's ROI counts cut to the small canvases
CFG = dict(small.CFG, **{"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32, "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200,
                         "MODEL.RPN.PRE_NMS_TOPK_TEST": 100, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 64,
                         "MODEL.RPN.POST_NMS_TOPK_TEST": 64, "TEST.DETECTIONS_PER_IMAGE": 20})
COMPARED = ("first_loss_gap", "grad_gap", "change_gap", "teacher_gap")


def test_the_reference_replaying_its_own_choices_reads_0_and_refuses_nothing():
    cell = manifest.workload(manifest.manifest(), WORKLOAD)
    conf = manifest.config(cell["config"])
    mix = dict(manifest.traffic(cell["traffic"]), **small.MIX)
    pool, dicts = traffic_mod.make_pool(mix, 4, threads=2)
    extra = dict(CFG, SEED=4)
    own, chosen = rcnn_refrun.reference_steps(conf, extra, 4, pool, dicts, 3, small.CPU)
    again, replayed = rcnn_refrun.reference_steps(conf, extra, 4, pool, dicts, 3, small.CPU, program=chosen.chosen)
    numbers = compare.readings(own, again)
    assert all(numbers[k] == 0.0 for k in COMPARED), numbers
    counts = replayed.counts()
    assert all(counts[f"replay.step{i}.refused"] == 0 < counts[f"replay.step{i}.taken"] for i in range(3)), counts


def test_the_sampler_draws_follow_the_proposals():
    from benchmark.reference.ubtref.engine.replay import draw_slots

    theirs = torch.tensor([[3, 5, 8, 7, -1], [1, 2, 3, 4, -1]])
    mine = torch.tensor([[5, 3, 9, -1, 7], [1, 2, 3, 4, -1]])
    slots = draw_slots(mine, theirs, 10)
    # the same anchor takes its slot's draws, the rest pair up in order;
    # lists that agree keep their draws where they are
    assert slots.tolist() == [[1, 0, 2, 4, 3], [0, 1, 2, 3, 4]]
    gen = torch.Generator().manual_seed(0)
    ids = torch.rand((3, 400), generator=gen).argsort(1)[:, :64]
    theirs = torch.where(torch.rand((3, 64), generator=gen) < 0.1, -1, ids)
    mine = torch.where(torch.rand((3, 64), generator=gen) < 0.2, ids + 400, theirs).roll(5, 1)
    slots = draw_slots(mine, theirs, 800)
    assert (slots.sort(1).values == torch.arange(64)).all()
    same = (mine >= 0) & (torch.gather(theirs, 1, slots) == mine)
    assert (same == ((mine[:, :, None] == theirs[:, None, :]) & (mine >= 0)[:, :, None]).any(2)).all()


def _lowest_first_nms(nms_keep):
    """The RPN's NMS ranking its candidates from the lowest score up."""
    def keep(boxes, scores, valid, thresh):
        return nms_keep(boxes, torch.where(valid, -scores, scores), valid, thresh)
    return keep


def _next_images_pseudo(threshold):
    """Each unlabeled image given the pseudo labels of the next one."""
    def pseudo(*args, **kwargs):
        return threshold(*args, **kwargs).map(lambda x: x.roll(-1, 0))
    return pseudo


def _shifted_anchor_labels(match):
    """The anchor matcher's labels and matched gts moved one anchor on."""
    def matched(*args, **kwargs):
        idx, labels = match(*args, **kwargs)
        return idx.roll(1, 1), labels.roll(1, 1)
    return matched


FAULTS = {
    "nms_keeps_the_lowest": (rpn, "nms_keep", _lowest_first_nms),
    "pseudo_labels_of_the_next_image": (rcnn_trainer, "threshold_pseudo_labels", _next_images_pseudo),
    "anchor_labels_shifted_by_one": (rcnn_trainer, "match_anchors_batched", _shifted_anchor_labels),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_program_that_chooses_wrongly_is_refused_and_not_correct(monkeypatch, fault):
    module, name, make = FAULTS[fault]
    monkeypatch.setattr(module, name, make(getattr(module, name)))
    from benchmark.run import run_cell
    import time

    result, lines = run_cell(WORKLOAD, 6, 0.5, False, small.CPU, time.perf_counter(), CFG, small.MIX)
    refused = sum(int(line.split()[1]) for line in lines if line.startswith("replay.step")
                  and line.split()[0].endswith(".refused"))
    assert refused > 0, lines
    limits = manifest.limits(WORKLOAD)
    beyond = [k for k, c in result["checks"].items() if not isinstance(c["value"], float) or c["value"] > c["limit"]]
    assert beyond and not result["correct"], (result["checks"], limits)


@pytest.mark.card
def test_the_control_is_not_correct_on_the_card(card):
    from benchmark.harness import rcnn_train_cell

    numbers = rcnn_train_cell.control(7, card)
    limits = manifest.limits(WORKLOAD)
    assert not compare.judge({k: numbers[k] for k in limits}, limits), numbers
