"""On the card, at each cell's own size: the control (the plain reference
with float8 operands in every product, in the program's place) comes out
not correct against the cell's limits. Skipped without a CUDA device.

    python -m pytest benchmark/tests/test_bench_card.py   (on the chip)"""

import pytest

from benchmark.harness import compare, manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    from benchmark.harness import control

    numbers = control.control_readings(workload, 7, card)
    limits = manifest.limits(workload)
    assert not compare.judge({k: numbers[k] for k in limits}, limits), numbers
