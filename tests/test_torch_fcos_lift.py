"""The port's FCOS SSOD lift, the opt-in twin of tests/test_fcos_lift.py.

Runs the supervised-vs-SSOD ablation of
ubteacher_tpu_torch/tools/learning_sanity.py at the recipe that
tests/test_fcos_lift.py pins (1000 steps, burn-in 600, size 128, 64 images
of which 8 labeled, colour jitter 40, seed 0) and asserts what that test
asserts: the SSOD student and teacher beat the supervised student on
held-out AP, and the pseudo-label gate is alive (mean pseudo boxes a batch
above 1). It runs on the card when there is one, else on the CPU (hours
there, as the JAX twin's docstring measures), so it is skipped unless
UBT_RUN_LIFT_TEST=1. On the card the same run is
`python -m ubteacher_tpu_torch.tools.learning_sanity --ablation --steps 1000
--burnin 600` (PERF.md records its results and wall time).
"""

import os
import types

import pytest
import torch


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("UBT_RUN_LIFT_TEST"),
                    reason="a 2,000-step training run (minutes on a card, hours on the CPU); "
                           "set UBT_RUN_LIFT_TEST=1 to run")
def test_fcos_ssod_lift_reproduces():
    from ubteacher_tpu_torch.tools.learning_sanity import run_ablation

    args = types.SimpleNamespace(
        rcnn=False, steps=1000, burnin=600, size=128, images=64, label_images=8, jitter=40, bbox_thresh=None,
        seed=0, cpu=not torch.cuda.is_available(),
    )
    out = run_ablation(args)
    assert out["ssod_beats_sup_student"], out
    assert out["ssod_beats_sup_teacher"], out
    # the gate must be alive: mean pseudo boxes per 8-image batch over the
    # mutual phase
    assert out["ssod"]["mean_pseudo_boxes"] > 1.0, out
