"""device_idle_pct.train: 1 - device busy per iteration / the window's
seconds per iteration, %. Busy comes from the traced iterations (the union
of the device's own rows, which the profiler does not lengthen); the
period from the untraced window, since the profiler slows the host's
launches and would add idle time of its own (the method of the port's
`tools/profile_step.py`: profiled busy time against unprofiled walls).
The traced iterations draw their own canvas pairs, so their busy time is
scaled to the window's mix by the FLOP table: busy per FLOP of the traced
iterations times the FLOPs of the window's mean iteration."""


def read(run):
    trace = run.get("trace")
    periods = run.get("periods_s")
    flops, traced = run.get("window_flops"), run.get("trace_flops")
    if not trace or not periods or not flops or not traced:
        return None
    busy = trace["busy_s"] / sum(traced) * (sum(flops) / len(flops))
    return 100.0 * (1.0 - busy / (run["window_s"] / len(periods)))
