"""The port's own spans against the card's idle time: one traced run of a
train cell, its profile reduced by harness/program_trace.py.

    python -m benchmark.program_spans --workload <name> --seed <n> --seconds <s>

The run is benchmark.run's with --trace 1 (the same set-up, window and
traced iterations) without the correctness comparison. Standard error gets
each span's own idle ms, device ms and launches over the traced window and
in each traced iteration; the last line on standard output is a JSON
object: the device's busy seconds and the traced window (harness/trace.py),
the idle between the device's rows, the share of it whose gap's midpoint
lies inside `ubt.step`, and each span's totals. A diagnostic beside the
benchmark: no cell runs it, and a cell's result line holds none of it."""

import argparse
import importlib
import json
import sys
from typing import Dict, List, Tuple


def spans_of_cell(workload: str, seed: int, seconds: float, device, cfg_extra=None,
                  mix_extra=None) -> Tuple[Dict, List[str]]:
    """-> (the summary, lines for standard error) of one traced run of
    `workload` on `device` (a test passes the CPU at a small size: no device
    rows, so the summary holds the window alone)."""
    from .harness import manifest, program_trace
    from .run import keep_tensorflow_out

    keep_tensorflow_out()
    cell = manifest.workload(manifest.manifest(), workload)
    kind = manifest.traffic(cell["traffic"])["cell"]
    Cell = importlib.import_module(f".harness.{kind}_cell", __package__).Cell
    cell_run = Cell(cell, seed, seconds, True, device, cfg_extra, mix_extra)
    cell_run.build()
    run = cell_run.run()
    reduced = program_trace.reduce_profile(cell_run.profile) if cell_run.profile is not None else {}
    cell_run.free()
    trace = run.get("trace") or {}
    out = {"workload": workload, "seed": seed, "busy_s": trace.get("busy_s"),
           "traced_window_s": trace.get("window_s"), "traced_iterations": cell_run.trace_steps, "rows": reduced.get("rows"), "idle_ms": reduced.get("idle_ms")}
    if reduced.get("idle_ms") and "idle_in_step_ms" in reduced:
        out["idle_in_step_pct"] = 100.0 * reduced["idle_in_step_ms"] / reduced["idle_ms"]
    out["spans"] = reduced.get("spans", {})
    return out, [f"{k} {v!r}" for k, v in program_trace.details(reduced).items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from .run import set_cache_dirs
    from .harness import manifest

    set_cache_dirs(manifest.ROOT)
    torch.set_num_threads(1)  # as benchmark.run
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    summary, lines = spans_of_cell(args.workload, args.seed, args.seconds, torch.device("cuda", 0))
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(summary, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
