"""queue_wait_pct.train: the program's `queue_wait_time` (its
`ubt.loader.queue_wait` span: the loop blocked on the loader's queue)
summed over the window's iterations, as a share of the window. None where
the program records no such span."""


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any("queue_wait_time" not in s for s in scalars):
        return None
    return 100.0 * sum(s["queue_wait_time"] for s in scalars) / run["window_s"]
