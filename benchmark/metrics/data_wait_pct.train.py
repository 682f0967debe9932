"""data_wait_pct.train: the program's own `data_time` (host seconds taking
batches from the loader and starting their copies) summed over the
window's iterations, as a share of the window."""


def read(run):
    scalars = run.get("window_scalars")
    if not scalars:
        return None
    return 100.0 * sum(s["data_time"] for s in scalars) / run["window_s"]
