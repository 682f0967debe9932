"""What the host did over a run's window, printed beside the compared
numbers (not metrics): the process's own CPU time (all its threads) in
cores and per image, and the rate in each half of the window, so that a
run's rate can be read against the speed of the host it ran on and
against growth across the run. (A sandboxed machine's /proc shows no load
of other processes, so only the process's own time is read.)"""

from __future__ import annotations

import os
import time
from typing import Dict, List


def sample() -> Dict[str, float]:
    t = os.times()
    return {"t": time.perf_counter(), "cpu": t.user + t.system}


def window(start: Dict[str, float], end: Dict[str, float], periods: List[float],
           images_per_iteration: int) -> Dict[str, float]:
    """host.* and window.* readings between two samples over a window whose
    iterations took `periods`."""
    cpu = end["cpu"] - start["cpu"]
    out = {"host.cores": os.cpu_count(), "host.self_cores": cpu / (end["t"] - start["t"])}
    n = len(periods) // 2
    if n:
        out["host.self_cpu_s_per_img"] = cpu / (len(periods) * images_per_iteration)
        out["window.img_s.first_half"] = n * images_per_iteration / sum(periods[:n])
        out["window.img_s.second_half"] = (len(periods) - n) * images_per_iteration / sum(periods[n:])
    return out
