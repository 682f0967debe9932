"""step_graph_pct.train's arithmetic on hand-made runs: nothing where the
program reports no replay count (a program without CUDA graphs), else the
share of the window's iterations that replayed one."""

import pytest

from benchmark.harness import manifest


def read(run):
    return manifest.reader("step_graph_pct.train")(run)


@pytest.mark.parametrize("replays, want", [
    (None, None),  # the scalar absent: the program has no step graphs
    ([1.0] * 8, 100.0),
    ([0.0] * 8, 0.0),
    ([1.0] * 6 + [0.0] * 2, 75.0),
])
def test_step_graph_share_of_the_windows_iterations(replays, want):
    scalars = [{"time": 0.3, "total_loss": 1.0} for _ in range(8)]
    if replays is not None:
        for s, r in zip(scalars, replays):
            s["step_graph_replays"] = r
    run = {"window_scalars": scalars, "window_s": 2.4}
    assert read(run) == want
    assert read({}) is None
