"""roi_align_fwd_roofline_pct.train: the ROIAlign forward kernel's share of
its roofline, %: the least seconds of the forward calls of the traced
iterations (harness/rcnn_bounds.py, from the calls the harness recorded)
over the traced device time of the trace's "ROIAlign forward" rows. None
where either is missing."""


def read(run):
    trace, bounds = run.get("trace"), run.get("kernel_bounds")
    if not trace or not bounds or not trace["group_ms"].get("ROIAlign forward"):
        return None
    return 100.0 * bounds["roi_align_fwd_s"] / (trace["group_ms"]["ROIAlign forward"] * trace["steps"] / 1e3)
