"""roi_head_device_ms.train: device ms per traced iteration of the rows
launched inside the program's `ubt.step.roi_head` span (ROIAlign and the
box head's forward, teacher and student; harness/program_trace.py). None
where the program records no such span."""


def read(run):
    span = (run.get("program_trace") or {}).get("spans", {}).get("ubt.step.roi_head")
    if not span:
        return None
    return span["device_ms"] / run["trace_steps"]
