"""iter_ms_p90.train: the 90th percentile of all the window's iteration
periods (one iteration's end to the next, loader waits included), ms: the
stalls that train_img_s averages away."""

import statistics


def read(run):
    periods = run.get("periods_s")
    if not periods or len(periods) < 2:
        return None
    return statistics.quantiles(periods, n=10, method="inclusive")[8] * 1e3
