"""fetch_wait_ms.train: the median over the window of the program's
`fetch_time` (its `ubt.train.metrics_fetch` span: the iteration's one
transfer of the step's metrics, its wait for the device), ms. None where
the program records no such span."""

import statistics


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any("fetch_time" not in s for s in scalars):
        return None
    return statistics.median(s["fetch_time"] for s in scalars) * 1e3
