"""The program's own spans on the profiler's clock: the port's `ubt.*`
ranges (`ubteacher_tpu_torch/utils/events.py` `span`, recorded while a
profiler runs) on the trainer's loop thread, against the device rows of
the same torch.profiler trace as harness/trace.py selects them.

The spans cut the traced window into pieces, each owned by the innermost
span over it (or by none). Each span gets, as its own share:
  * idle ms: the part of the device's idle gaps (between its rows, as
    harness/trace.py counts them) that lies in its pieces;
  * device ms and launches: the device rows whose launch (the CUDA runtime
    or driver call that shares the row's correlation id) lies in its pieces.
The shares sum to the totals: every idle gap and every row lands in one
piece. They are read for the whole traced window and for each traced
iteration: each recorded `ubt.train.iteration` span, and after the last
one, where steps follow, the iteration the profiler stopped in (whose
iteration span the trace may lack). A trace that holds no `ubt.*` span (a
program without them) gives only the totals."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from . import trace as trace_mod

PREFIX = "ubt."
ITERATION = "ubt.train.iteration"
STEP = "ubt.step"
NO_SPAN = "(no span)"


def _rows_and_spans(prof):
    """(device rows [(start_us, end_us, launch_us or None)], loop-thread spans
    [(start_us, end_us, name)]). Rows are those harness/trace.py `_events`
    keeps: the device's own, not a span's annotation over them."""
    from torch.autograd import DeviceType

    rows, launches, spans = [], {}, []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type != DeviceType.CPU:
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("harness.")):
                rows.append((start, end, e.id))
        elif e.name.startswith(PREFIX):
            spans.append((start, end, e.name, e.thread))
        elif e.name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
            launches[e.id] = start
    loop = {t for s, e, n, t in spans if n == STEP}
    spans = sorted((s, e, n) for s, e, n, t in spans if not loop or t in loop)
    return [(s, e, launches.get(i)) for s, e, i in rows], spans


def _pieces(spans: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The spans' range cut where any span starts or ends, each piece owned
    by the innermost span over it (the latest to start; spans on one thread
    nest)."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        over = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        if over:
            out.append((a, b, max(over, key=lambda sp: (sp[0], -sp[1]))[2]))
    return out


class _Owner:
    """Which span owns a time, and the overlap of an interval with each."""

    def __init__(self, pieces):
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.pieces[i][2] if i >= 0 and t <= self.pieces[i][1] else NO_SPAN

    def split(self, a: float, b: float) -> Dict[str, float]:
        out: Dict[str, float] = {}
        covered = 0.0
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        while i < len(self.pieces) and self.pieces[i][0] < b:
            s, e, name = self.pieces[i]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
            i += 1
        if b - a - covered > 0:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - a - covered)
        return out


def _empty() -> Dict[str, float]:
    return {"idle_ms": 0.0, "device_ms": 0.0, "launches": 0}


def reduce_profile(prof) -> Dict:
    """-> {rows, idle_ms, idle_in_step_ms, unlaunched_device_ms, spans {name:
    {idle_ms, device_ms, launches}}, iterations [the same per traced
    iteration]}; spans, iterations and idle_in_step_ms only where the trace
    holds the program's spans. Empty where it holds no device row."""
    rows, spans = _rows_and_spans(prof)
    if not rows:
        return {}
    busy = trace_mod._union([(s, e) for s, e, _ in rows])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    out: Dict = {
        "rows": len(rows),
        "idle_ms": sum(b - a for a, b in gaps) / 1e3,
        "unlaunched_device_ms": sum(e - s for s, e, t in rows if t is None) / 1e3,
    }
    if not spans:
        return out
    owner = _Owner(_pieces(spans))
    iters = [(s, e) for s, e, n in spans if n == ITERATION]
    steps = [(s, e) for s, e, n in spans if n == STEP]
    last = iters[-1][1] if iters else float("-inf")
    if any(s > last for s, _ in steps):
        iters.append((last, float("inf")))
    totals: Dict[str, Dict[str, float]] = {}
    per_iter: List[Dict[str, Dict[str, float]]] = [{} for _ in iters]

    def add(t: float, name: str, key: str, value: float) -> None:
        for table in [totals] + [per_iter[k] for k, (s, e) in enumerate(iters) if s <= t <= e]:
            table.setdefault(name, _empty())[key] += value

    in_step = 0.0
    for a, b in gaps:
        mid = (a + b) / 2
        if any(s <= mid <= e for s, e in steps):
            in_step += b - a
        for name, part in owner.split(a, b).items():
            add((a + b) / 2, name, "idle_ms", part / 1e3)
    for s, e, launch in rows:
        if launch is not None:
            name = owner.at(launch)
            add(launch, name, "device_ms", (e - s) / 1e3)
            add(launch, name, "launches", 1)
    out.update(idle_in_step_ms=in_step / 1e3, spans=totals, iterations=per_iter)
    return out


def details(reduced: Optional[Dict]) -> Dict[str, object]:
    """The readings as lines for standard error: the totals, then each
    span's own share over the traced window and in each traced iteration."""
    if not reduced:
        return {}
    out = {f"program_trace.{k}": reduced[k] for k in ("rows", "idle_ms", "idle_in_step_ms", "unlaunched_device_ms")
           if k in reduced}
    for name, v in sorted(reduced.get("spans", {}).items()):
        out[f"program_trace.all.{name}"] = v
    for i, table in enumerate(reduced.get("iterations", []), 1):
        for name, v in sorted(table.items()):
            out[f"program_trace.iter{i}.{name}"] = v
    return out
