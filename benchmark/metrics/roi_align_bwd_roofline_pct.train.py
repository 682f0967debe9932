"""roi_align_bwd_roofline_pct.train: the ROIAlign backward kernel's share
of its roofline, %: the least seconds of the backward of the traced
iterations' calls (harness/rcnn_bounds.py) over the traced device time of
the trace's "ROIAlign backward" rows. None where either is missing."""


def read(run):
    trace, bounds = run.get("trace"), run.get("kernel_bounds")
    if not trace or not bounds or not trace["group_ms"].get("ROIAlign backward"):
        return None
    return 100.0 * bounds["roi_align_bwd_s"] / (trace["group_ms"]["ROIAlign backward"] * trace["steps"] / 1e3)
