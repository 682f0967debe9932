"""The readers of the program's spans and counters, and
harness/program_trace.py, on hand-made runs and traces; program_spans.py
on a small traced run on the CPU."""

from types import SimpleNamespace

import pytest

from benchmark.harness import manifest, program_trace, trace

READERS = ("queue_wait_pct.train", "h2d_ms.train", "loader_cpu_ms_per_img.train", "dispatch_ms.train",
           "dispatch_cpu_pct.train", "fetch_wait_ms.train")


def read(name, run):
    return manifest.reader(name)(run)


def span_run():
    rows = [
        {"queue_wait_time": 0.001, "h2d_time": 0.010, "dispatch_time": 0.300, "backward_time": 0.050,
         "fetch_time": 0.020, "dispatch_cpu_time": 0.200, "loader_cpu_time": 1.0, "loader_images": 16},
        {"queue_wait_time": 0.003, "h2d_time": 0.030, "dispatch_time": 0.340, "backward_time": 0.040,
         "fetch_time": 0.040, "dispatch_cpu_time": 0.240, "loader_cpu_time": 1.4, "loader_images": 16},
        {"queue_wait_time": 0.000, "h2d_time": 0.020, "dispatch_time": 0.320, "backward_time": 0.060,
         "fetch_time": 0.030, "dispatch_cpu_time": 0.160, "loader_cpu_time": 1.2, "loader_images": 8},
    ]
    return {"window_s": 1.2, "window_scalars": rows}


def test_span_readers_arithmetic():
    run = span_run()
    assert read("queue_wait_pct.train", run) == pytest.approx(100 * 0.004 / 1.2)
    assert read("h2d_ms.train", run) == pytest.approx(20.0)
    assert read("loader_cpu_ms_per_img.train", run) == pytest.approx(1e3 * 3.6 / 40)
    assert read("dispatch_ms.train", run) == pytest.approx(320.0)
    assert read("dispatch_cpu_pct.train", run) == pytest.approx(100 * 0.6 / (0.96 - 0.15))
    assert read("fetch_wait_ms.train", run) == pytest.approx(30.0)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_from_a_program_without_spans(name):
    """The window's scalars of a program that records no spans (only `time`
    and `data_time`), and a trace that holds none of its spans."""
    run = {"window_s": 1.0, "window_scalars": [{"time": 0.3, "data_time": 0.01, "total_loss": 1.0}]}
    assert read(name, run) is None
    assert read(name, {}) is None


def _event(name, start, end, device="CPU", eid=0, thread=1, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), id=eid, thread=thread,
                           device_type=getattr(DeviceType, device), is_user_annotation=annotation)


def _profile(spans=True):
    """One traced iteration (times in us): the step with its losses and
    backward, then the metrics fetch; four device rows launched from the
    step, its losses, its backward (autograd's thread) and the iteration,
    one row whose launch the trace lacks, and the step's annotation on the
    device's timeline."""
    evs = [
        _event("cudaLaunchKernel", 105, 108, eid=10), _event("k_a", 110, 190, "CUDA", eid=10),
        _event("cudaLaunchKernel", 210, 212, eid=11), _event("k_b", 250, 260, "CUDA", eid=11),
        _event("cudaLaunchKernel", 310, 312, eid=12, thread=2), _event("k_c", 700, 720, "CUDA", eid=12),
        _event("cudaLaunchKernel", 910, 912, eid=13), _event("k_d", 920, 950, "CUDA", eid=13),
        _event("k_e", 960, 970, "CUDA", eid=99),
        _event("ubt.step", 150, 550, "CUDA", eid=2, annotation=True),
    ]
    if spans:
        evs += [_event("ubt.train.iteration", 0, 1000, eid=1, annotation=True),
                _event("ubt.step", 100, 600, eid=2, annotation=True),
                _event("ubt.step.losses", 200, 300, eid=3, annotation=True),
                _event("ubt.step.backward", 300, 500, eid=4, annotation=True),
                _event("ubt.train.metrics_fetch", 650, 900, eid=5, annotation=True)]
    return SimpleNamespace(events=lambda: evs)


def test_gaps_and_rows_go_to_the_innermost_span():
    prof = _profile()
    out = program_trace.reduce_profile(prof)
    # the rows harness/trace.py keeps: the step's device annotation is not one
    assert out["rows"] == len(trace._events(prof)[0]) == 5
    assert out["idle_ms"] == pytest.approx(0.710)
    assert out["idle_in_step_ms"] == pytest.approx(0.500)  # the gaps centred at 220 and 480 us
    assert out["unlaunched_device_ms"] == pytest.approx(0.010)
    want = {
        "ubt.step": (0.110, 0.080, 1),  # gap 190-200 and 500-600; row a
        "ubt.step.losses": (0.090, 0.010, 1),  # gap 200-250 and 260-300; row b
        "ubt.step.backward": (0.200, 0.020, 1),  # launched from autograd's thread inside the span
        "ubt.train.iteration": (0.080, 0.030, 1),  # 600-650, 900-920, 950-960; row d
        "ubt.train.metrics_fetch": (0.230, 0.0, 0),  # 650-700, 720-900
    }
    for table in (out["spans"], out["iterations"][0]):
        assert set(table) == set(want)
        for name, (idle, device, launches) in want.items():
            got = table[name]
            assert (got["idle_ms"], got["device_ms"], got["launches"]) == (
                pytest.approx(idle), pytest.approx(device), launches), name
    assert sum(v["idle_ms"] for v in out["spans"].values()) == pytest.approx(out["idle_ms"])
    lines = program_trace.details(out)
    assert lines["program_trace.iter1.ubt.step.backward"]["idle_ms"] == pytest.approx(0.2)
    assert lines["program_trace.idle_ms"] == out["idle_ms"]


def test_the_iteration_the_profiler_stopped_in_is_read_too():
    """A trace that lacks the last iteration's span (open when the profiler
    stopped): its step and what follows make one more iteration."""
    evs = [e for e in _profile().events() if e.name != "ubt.train.iteration"]
    out = program_trace.reduce_profile(SimpleNamespace(events=lambda: evs))
    assert len(out["iterations"]) == 1
    assert out["iterations"][0]["ubt.step.backward"]["idle_ms"] == pytest.approx(0.2)
    assert out["iterations"][0][program_trace.NO_SPAN]["idle_ms"] == pytest.approx(0.080)  # the loop's own
    assert sum(v["idle_ms"] for v in out["iterations"][0].values()) == pytest.approx(out["idle_ms"])


def test_a_trace_without_the_programs_spans_gives_the_totals_only():
    out = program_trace.reduce_profile(_profile(spans=False))
    assert out == {"rows": 5, "idle_ms": pytest.approx(0.710), "unlaunched_device_ms": pytest.approx(0.010)}
    assert program_trace.reduce_profile(SimpleNamespace(events=lambda: [])) == {}
    assert program_trace.details({}) == {}


def test_program_spans_reduces_the_profile_of_a_traced_run(monkeypatch):
    """The traced run's profile reaches the reduction and holds the
    program's spans on the loop thread; on the CPU it has no device rows,
    so the summary holds the window alone."""
    from benchmark import program_spans
    from benchmark.tests import small

    seen = []
    reduce = program_trace.reduce_profile
    monkeypatch.setattr(program_trace, "reduce_profile", lambda prof: seen.append(prof) or reduce(prof))
    summary, lines = program_spans.spans_of_cell("fcos_mutual_recipe", 3, 0.5, small.CPU, small.CFG, small.MIX)
    assert len(seen) == 1
    threads = {e.thread for e in seen[0].events() if e.name == "ubt.step"}
    assert len(threads) == 1
    names = {e.name for e in seen[0].events() if e.thread in threads and e.name.startswith("ubt.")}
    assert {"ubt.train.iteration", "ubt.step", "ubt.step.backward", "ubt.train.metrics_fetch"} <= names
    assert summary["workload"] == "fcos_mutual_recipe" and summary["traced_iterations"] >= 1
    assert summary["rows"] is None and summary["spans"] == {} and lines == []
