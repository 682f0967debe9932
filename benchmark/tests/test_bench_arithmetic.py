"""The metric readers' arithmetic on hand-made runs."""

import pytest

from benchmark.harness import manifest


def read(name, run):
    return manifest.reader(name)(run)


def train_run():
    periods = [0.30, 0.31, 0.32, 0.33, 0.34, 0.35, 0.36, 0.37, 0.38, 0.50]
    return {
        "periods_s": periods, "window_s": sum(periods), "images_per_iteration": 16,
        "window_scalars": [{"time": p - 0.01, "data_time": 0.01, "total_loss": 1.0} for p in periods],
        "window_flops": [3.0e13] * 5 + [2.0e13] * 5,
        "peak_flops": 1.0e15, "memory_peak_bytes": 3 * 2**30, "setup_s": 12.5,
        # the traced iterations drew the window's mean pair
        "trace": {"busy_s": 0.9, "steps": 3, "window_s": 1.2, "group_ms": {"elementwise": 140.0}},
        "trace_flops": [2.5e13] * 3,
    }


def test_rate_is_all_images_over_the_window():
    run = train_run()
    assert read("train_img_s", run) == pytest.approx(10 * 16 / sum(run["periods_s"]))


def test_p90_is_over_every_period():
    run = train_run()
    # inclusive quantiles of 10 values: the 9th cut lies at 0.1 of the way from the 9th to the 10th
    assert read("iter_ms_p90.train", run) == pytest.approx((0.38 + 0.1 * (0.50 - 0.38)) * 1e3)
    assert read("iter_ms_p90.train", dict(run, periods_s=[0.3])) is None


def test_mfu_sums_each_iterations_pair_from_the_table():
    run = train_run()
    flops = 5 * 3.0e13 + 5 * 2.0e13
    assert read("mfu.train", run) == pytest.approx(100 * flops / run["window_s"] / 1e15)
    assert read("mfu.train", {k: v for k, v in run.items() if k != "peak_flops"}) is None


def test_traced_readings_are_scaled_to_the_windows_canvas_mix():
    # three traced iterations on the largest pair: a third more work an
    # iteration than the window's mean, so a third less busy time counts
    run = dict(train_run(), trace_flops=[3.0e13] * 3)
    period = run["window_s"] / 10
    assert read("device_idle_pct.train", run) == pytest.approx(100 * (1 - 0.3 * 2.5 / 3.0 / period))
    assert read("elementwise_ms.train", run) == pytest.approx(140.0 * 2.5 / 3.0)
    assert read("device_idle_pct.train", dict(run, trace_flops=None)) is None


def test_program_counters_and_trace_readers():
    run = train_run()
    assert read("data_wait_pct.train", run) == pytest.approx(100 * 0.1 / run["window_s"])
    assert read("step_ms.train", run) == pytest.approx(1e3 * (0.345 - 0.01))
    assert read("elementwise_ms.train", run) == 140.0
    assert read("device_idle_pct.train", run) == pytest.approx(100 * (1 - 0.3 / (run["window_s"] / 10)))
    assert read("peak_mem_gib", run) == 3.0 and read("setup_s", run) == 12.5
    assert read("device_idle_pct.train", dict(run, trace=None)) is None


def test_readers_return_nothing_where_nothing_was_read():
    for m in manifest.manifest()["per_layer"] + manifest.manifest()["end_to_end"]:
        assert manifest.reader(m["name"])({}) is None, m["name"]


def test_host_readings_over_a_window():
    from benchmark.harness import host

    out = host.window({"t": 10.0, "cpu": 3.0}, {"t": 12.0, "cpu": 11.0}, [0.5, 0.5, 0.25, 0.75], 16)
    assert out["host.self_cores"] == 4.0 and out["host.self_cpu_s_per_img"] == 8.0 / 64
    assert out["window.img_s.first_half"] == 32.0 and out["window.img_s.second_half"] == 32.0
