"""proposal_device_ms.train: device ms per traced iteration of the rows
launched inside the program's `ubt.step.rpn_proposals` span (the RPN's
top-k, NMS and global top-k at train and test settings;
harness/program_trace.py). None where the program records no such span."""


def read(run):
    span = (run.get("program_trace") or {}).get("spans", {}).get("ubt.step.rpn_proposals")
    if not span:
        return None
    return span["device_ms"] / run["trace_steps"]
