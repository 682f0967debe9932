"""The R-CNN configuration's FLOP table is what the frozen reference's R-CNN
counts (harness/rcnn_flops.py), and its base-canvas step is the count the
port's `tools/mfu.py` made around its own mutual step."""

from benchmark.harness import manifest, rcnn_flops
from benchmark.tests import small

CONFIG = "rcnn_r50_fpn_coco_sup1"


def test_the_rcnn_table_regenerates():
    assert rcnn_flops.table(CONFIG) == manifest.flop_table(CONFIG)


def test_the_base_canvas_step_is_the_ports_count_within_2_percent():
    # tools/flops_mutual.json's R-CNN entry (FlopCounterMode around the
    # port's mutual step at 8 + 8, 768 x 1344): 29.581 TFLOP
    mutual = manifest.flop_table(CONFIG)["mutual"]["768x1344|768x1344"]
    assert abs(mutual / 29.581e12 - 1) < 0.02


def test_small_table_combines_per_image_counts():
    t = rcnn_flops.table(CONFIG, dict(small.CFG, **{"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32,
                                                    "MODEL.RPN.POST_NMS_TOPK_TEST": 64}))
    per = t["per_image"]
    assert t["mutual"]["64x96|96x64"] == 2 * per["96x64"]["inference"] + 4 * per["64x96"]["train"] + 2 * per["96x64"]["train"]
    assert per["64x96"]["inference"] < per["64x96"]["train"] < 3 * per["64x96"]["inference"]
