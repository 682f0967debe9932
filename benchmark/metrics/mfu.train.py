"""mfu.train: the benchmark's FLOP count of every window iteration (its
canvas pair's entry in flops/<config>.json) over the window's seconds, as a
share of the card's dense bf16 peak."""


def read(run):
    flops = run.get("window_flops")
    if not flops or "peak_flops" not in run:
        return None
    return 100.0 * sum(flops) / run["window_s"] / run["peak_flops"]
