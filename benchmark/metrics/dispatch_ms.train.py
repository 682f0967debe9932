"""dispatch_ms.train: the median over the window of the program's
`dispatch_time` (its `ubt.step` span: the step call, entry to return), ms.
None where the program records no such span."""

import statistics


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any("dispatch_time" not in s for s in scalars):
        return None
    return statistics.median(s["dispatch_time"] for s in scalars) * 1e3
