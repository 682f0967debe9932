"""elementwise_ms.train: device ms per iteration of the elementwise group
(the trace's rows grouped as harness/trace.py GROUPS), scaled from the
traced iterations' canvas pairs to the window's mix by the FLOP table:
ms per FLOP of the traced iterations times the FLOPs of the window's mean
iteration."""


def read(run):
    trace = run.get("trace")
    flops, traced = run.get("window_flops"), run.get("trace_flops")
    if not trace or "elementwise" not in trace["group_ms"] or not flops or not traced:
        return None
    ms = trace["group_ms"]["elementwise"] * trace["steps"]
    return ms / sum(traced) * (sum(flops) / len(flops))
