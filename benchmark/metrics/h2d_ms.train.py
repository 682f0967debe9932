"""h2d_ms.train: the median over the window of the program's `h2d_time`
(its `ubt.train.h2d` span: pinning the next batch and starting its copy to
the device), ms. None where the program records no such span."""

import statistics


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any("h2d_time" not in s for s in scalars):
        return None
    return statistics.median(s["h2d_time"] for s in scalars) * 1e3
