"""anchor_match_roofline_pct.train: the anchor matcher's share of its
roofline, %: the least seconds of the traced iterations' matcher calls
(harness/rcnn_bounds.py, from the calls the harness recorded) over the
traced device time of the trace's "matcher" rows (csrc/matcher.cu's two
kernels). None where either is missing."""


def read(run):
    trace, bounds = run.get("trace"), run.get("kernel_bounds")
    if not trace or not bounds or not trace["group_ms"].get("matcher"):
        return None
    return 100.0 * bounds["match_s"] / (trace["group_ms"]["matcher"] * trace["steps"] / 1e3)
