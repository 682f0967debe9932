"""step_graph_pct.train: the share of the window's iterations whose step ran
as a replayed CUDA graph: 100 x the program's `step_graph_replays` (its
`ubt.step.graph_replay` span's count) summed over the window, over the
window's iterations. None where the program records no such scalar."""


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any("step_graph_replays" not in s for s in scalars):
        return None
    return 100.0 * sum(s["step_graph_replays"] for s in scalars) / len(scalars)
