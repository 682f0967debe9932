"""The plain reference against the port at a small size on the CPU: a whole
train-cell run (set-up, warm-up, the window, the reference's first steps)
where both sides compute in float32 with the same plain arithmetic, so the
compared numbers sit at round-off."""

from benchmark.tests import small


def test_port_and_reference_agree_at_a_small_size():
    result, lines = small.run(seed=2**31 + 7, seconds=2.0)
    checks = result["checks"]
    assert result["correct"], lines
    assert checks["first_loss_gap"]["value"] < 1e-4
    assert checks["grad_gap"]["value"] < 1e-3
    assert checks["change_gap"]["value"] < 1e-3
    assert checks["teacher_gap"]["value"] < 1e-3
    assert result["attempted"] >= 1 and result["failed"] == 0
    # no device metric off the card
    assert set(result["metrics"]) == {"train_img_s", "setup_s"}


def test_traced_run_reports_the_host_side_layer_metrics():
    result, _ = small.run(seed=11, trace=True)
    assert {"data_wait_pct.train", "step_ms.train"} <= set(result["metrics"])
    assert "device_idle_pct.train" not in result["metrics"]  # no device rows in a CPU trace
    assert "mfu.train" not in result["metrics"]  # no card, no peak

