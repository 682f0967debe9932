"""step_ms.train: the median of the program's per-iteration `time` (the
step's dispatch to its metrics on the host) over the window, ms."""

import statistics


def read(run):
    scalars = run.get("window_scalars")
    if not scalars:
        return None
    return statistics.median(s["time"] for s in scalars) * 1e3
