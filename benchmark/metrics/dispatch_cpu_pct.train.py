"""dispatch_cpu_pct.train: the loop thread's CPU seconds in the step outside
its backward (the program's `dispatch_cpu_time`) over the wall seconds of
the same (`dispatch_time` - `backward_time`), summed over the window, %.
Under 100 where the thread waited while dispatching: for the interpreter
lock, or for the device. None where the program records no such span."""

KEYS = ("dispatch_cpu_time", "dispatch_time", "backward_time")


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any(k not in s for s in scalars for k in KEYS):
        return None
    wall = sum(s["dispatch_time"] - s["backward_time"] for s in scalars)
    if wall <= 0:
        return None
    return 100.0 * sum(s["dispatch_cpu_time"] for s in scalars) / wall
