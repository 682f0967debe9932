"""The FLOP tables are what the frozen reference counts, and an iteration's
entry is the sum the steps run."""

import os

import pytest

from benchmark.harness import flops, manifest
from benchmark.tests import small


@pytest.mark.parametrize("config", sorted(f[:-5] for f in os.listdir(os.path.join(manifest.BENCH_DIR, "flops"))))
def test_tables_regenerate(config):
    assert flops.table(config) == manifest.flop_table(config)


def test_mutual_counts_at_the_base_canvas():
    # the counts `tools/mfu.py` made over the port's own steps at 8 + 8,
    # 768 x 1344 (FlopCounterMode around the mutual step): the same work
    table = manifest.flop_table("fcos_r50_coco_sup1")
    assert table["mutual"]["768x1344|768x1344"] == 31065326272512


def test_small_table_combines_per_image_counts():
    t = flops.table("fcos_r50_coco_sup1", small.CFG)
    per = t["per_image"]
    assert set(t["burnin"]) == {"64x96", "96x64"} and len(t["mutual"]) == 4
    assert t["mutual"]["64x96|96x64"] == 2 * per["96x64"]["inference"] + 4 * per["64x96"]["train"] + 2 * per["96x64"]["train"]
    # the frozen stem and res2 take no backward: less than three forwards
    assert per["64x96"]["inference"] < per["64x96"]["train"] < 3 * per["64x96"]["inference"]
