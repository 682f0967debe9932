"""The port's spans (utils/events.py `span`): the cumulative table every span
adds to, the `record_function` ranges it opens only while a profiler
records, and what the trainer loop reads from them each iteration (the
`*_time`, `loader_*` scalars beside `time` and `data_time`), on a
2-iteration CPU run (a burn-in step, then a mutual step)."""

import sys
import threading

import pytest
import torch

from torch_dp_worker import RecordingStorage
from torch_parity import (  # noqa: F401 (fixtures: autouse, or named in usefixtures)
    SPAN_SCALARS,
    canvas_opts,
    few_torch_threads,
    remove_large_files_at_teardown,
    synthetic_coco,
    tmp_budget,
    trainer_cfgs,
    trainer_datasets,
)
from ubteacher_tpu_torch.utils import events

STEP_PHASES = {
    "burnin": ("ubt.step.strong_aug", "ubt.step.student_forward", "ubt.step.losses", "ubt.step.backward",
               "ubt.step.optimizer"),
    "mutual": ("ubt.step.ema", "ubt.step.teacher_forward", "ubt.step.pseudo_labels", "ubt.step.strong_aug",
               "ubt.step.student_forward", "ubt.step.losses", "ubt.step.backward", "ubt.step.optimizer"),
}


def test_span_without_a_profiler_opens_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = events.span_totals().get("ubt.test.plain", (0, 0.0, 0.0))
    with events.span("ubt.test.plain"):
        sum(range(1000))
    count, wall, cpu = events.span_totals()["ubt.test.plain"]
    assert count == before[0] + 1
    assert wall > before[1] and cpu >= before[2]


def test_the_table_counts_every_span_of_many_threads():
    """Threads that outnumber the cores, switching every microsecond, lose
    no update of the shared table."""
    name, threads, each = "ubt.test.threads", 16, 300
    before = events.span_totals().get(name, (0, 0.0, 0.0))[0]

    def work():
        for _ in range(each):
            with events.span(name):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert events.span_totals()[name][0] - before == threads * each


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory, request):
    """A 2-iteration trainer run under torch.profiler on the CPU -> (the
    profile, each iteration's scalars, the table's change in counts)."""
    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

    out = tmp_path_factory.mktemp("spans")
    remove_large_files_at_teardown(request, out)
    dicts, image_loader = synthetic_coco(size=48)
    _, cfg = trainer_cfgs(out, extra_opts=canvas_opts(64, 48) + ["SOLVER.MAX_ITER", "2",
                                                                 "SEMISUPNET.BURN_UP_STEP", "1"])
    trainer = UBTeacherTrainer(cfg, datasets=trainer_datasets(dicts), image_loader=image_loader, device="cpu")
    trainer.storage = RecordingStorage()
    before = events.span_totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train()
    after = events.span_totals()
    change = {k: v[0] - before.get(k, (0,))[0] for k, v in after.items()}
    return prof, trainer.storage.rows, change


def _inside(outer, inner):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_trace_nests_iteration_step_and_phases_on_the_loop_thread(traced_run):
    prof, _, change = traced_run
    spans = [(e.time_range.start, e.time_range.end, e.name, e.thread) for e in prof.events()
             if e.name.startswith("ubt.")]
    # the profiler records on the loop's thread: the loader's spans open no
    # range on theirs
    assert len({t for *_, t in spans}) == 1
    iterations = sorted(s for s in spans if s[2] == "ubt.train.iteration")
    steps = sorted(s for s in spans if s[2] == "ubt.step")
    assert len(iterations) == len(steps) == 2
    for iteration, step, kind in zip(iterations, steps, ("burnin", "mutual")):
        assert _inside(iteration, step)
        names = {s[2] for s in spans if _inside(step, s) and s is not step}
        assert names == set(STEP_PHASES[kind]), kind
        loop_spans = {s[2] for s in spans if _inside(iteration, s)}
        assert {"ubt.train.metrics_fetch", "ubt.train.bookkeeping"} <= loop_spans
    # the second batch is fetched and sent inside the first iteration
    assert {"ubt.loader.queue_wait", "ubt.train.h2d"} <= {s[2] for s in spans if _inside(iterations[0], s)}
    assert change["ubt.step"] == 2 and change["ubt.train.iteration"] == 2
    assert change["ubt.loader.read"] >= 8 and change["ubt.loader.augment"] == change["ubt.loader.read"]


def test_iteration_scalars_read_the_spans(traced_run):
    from ubteacher_tpu_torch.engine.trainer import span_scalars

    _, rows, _ = traced_run
    assert set(span_scalars({}, {})) == set(SPAN_SCALARS)
    assert len(rows) == 2
    for row in rows:
        assert all(row[k] >= 0 for k in SPAN_SCALARS), row
        assert row["data_time"] >= row["queue_wait_time"] + row["h2d_time"] - 1e-3, row
        assert row["time"] >= row["dispatch_time"] >= row["backward_time"] > 0, row
        assert row["dispatch_cpu_time"] > 0
    assert sum(row["loader_images"] for row in rows) >= 8  # two batches of 2 + 2, and what was read ahead
