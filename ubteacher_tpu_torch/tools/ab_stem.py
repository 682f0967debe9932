"""A/B of TPU.STEM_MODE ("conv" against "pallas", the fused stem kernel
csrc/stem.cu) on both trainers' full-width mutual step, in one process.

For each trainer the modes run in turns, conv, pallas, pallas, conv (a
drift of the card over the run then falls on both modes alike). A turn
builds the recipe's step at 768x1344, 8 + 8 images (seeded weights and
batch, as tools/profile_step.py does) with the mode set, runs the burn-in,
boundary and two warm mutual steps, times WALL_STEPS steps on the host clock
(each to a synchronize), then profiles --repeats windows of --steps mutual
steps: the device's busy ms per step (the sum of its kernel and copy rows)
and, inside it, the stem's own rows (every kernel launched under the ResNet
stem of the teacher and the student: cuDNN conv, FrozenBN, ReLU and
max-pool in conv mode, the one fused kernel in pallas mode). A mode's
result is the minimum busy ms over its windows of both turns. The step
launches nearly the same kernels every time (a few data-dependent ones
aside), so a window that shows under WHOLE_SHARE of the turn's most kernel
launches lost profiler rows (seen on an H100: one of three windows at half
the busy time): it is reported, and left out of the minimum.

It measures on a card only: without one it stops.

    python -m ubteacher_tpu_torch.tools.ab_stem [--repeats 3] [--steps 3] \\
        [--modes conv pallas] [--families fcos rcnn]
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics

import torch

from .common import device_label, step_setup, triton_cache_in_checkout
from .profile_step import WALL_STEPS, device_rows, profiled, timed_steps

STEM_RANGE = "ubt_ab_stem"
STEM_ROW_CHARS = 100  # kernel names cut to fit a log line
WHOLE_SHARE = 0.99  # of the most kernel launches a turn's windows show


def mark_stems(*models) -> None:
    """Wrap each ResNet's stem in a profiler range named STEM_RANGE, so
    that the kernels it launches can be told apart (the model code stays
    as it is: the wrapper is an instance attribute)."""
    from ..modeling.resnet import ResNet

    for model in models:
        for m in model.modules():
            if isinstance(m, ResNet):
                stem = m.stem

                def marked(x, stem=stem):
                    with torch.profiler.record_function(STEM_RANGE):
                        return stem(x)

                m.stem = marked


def range_kernels(prof, name: str, steps: int) -> dict:
    """{kernel name: device ms per step} of every kernel launched inside the
    profile's ranges called `name`."""
    out = collections.Counter()

    def walk(e):
        for k in e.kernels:
            out[k.name] += k.duration / steps / 1e3
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name:
            walk(e)
    return dict(out)


def best_window(windows) -> dict:
    """The window of least busy time among those that kept their profiler
    rows (at least WHOLE_SHARE of the most kernel launches)."""
    most = max(w["launches"] for w in windows)
    return min((w for w in windows if w["launches"] >= WHOLE_SHARE * most), key=lambda w: w["busy_ms"])


def turn(family: str, mode: str, device, repeats: int, steps: int) -> dict:
    _, (burnin, mutual), state, data = step_setup(family == "rcnn", device, opts=["TPU.STEM_MODE", mode])
    mark_stems(state.student, state.teacher)
    state, _ = burnin(state, data)
    state, _ = timed_steps(mutual, state, data, 3)  # the boundary step and two warm ones
    state, walls = timed_steps(mutual, state, data, WALL_STEPS)
    windows = []
    for _ in range(repeats):
        state, prof = profiled(mutual, state, data, steps)
        rows = device_rows(prof, steps)
        stem = range_kernels(prof, STEM_RANGE, steps)
        windows.append({"busy_ms": sum(r[0] for r in rows), "stem_ms": sum(stem.values()), "stem_rows": stem,
                        "launches": sum(c for _, c, n in rows if not n.startswith(("Memcpy", "Memset")))})
    best = best_window(windows)
    del state, data
    torch.cuda.empty_cache()
    return {
        "family": family, "mode": mode,
        "wall_ms_median": round(statistics.median(walls), 2),
        "busy_ms_min": round(best["busy_ms"], 3),
        "stem_ms_at_min": round(best["stem_ms"], 4),
        "stem_rows_at_min": {k[:STEM_ROW_CHARS]: round(v, 4)
                             for k, v in sorted(best["stem_rows"].items(), key=lambda kv: -kv[1])},
        "all_busy": [round(w["busy_ms"], 3) for w in windows],
        "all_stem": [round(w["stem_ms"], 4) for w in windows],
        "all_launches": [round(w["launches"]) for w in windows],
    }


def run(device, families=("fcos", "rcnn"), modes=("conv", "pallas"), repeats: int = 3, steps: int = 3) -> dict:
    """Every family's turns (modes, then the same reversed) -> the summary:
    per family and mode the minimum busy ms over both turns, and its stem ms."""
    turns = []
    for family in families:
        for mode in list(modes) + list(reversed(modes)):
            r = turn(family, mode, device, repeats, steps)
            print(json.dumps(r), flush=True)
            turns.append(r)
    summary = {}
    for family in families:
        for mode in modes:
            mine = [t for t in turns if t["family"] == family and t["mode"] == mode]
            best = min(mine, key=lambda t: t["busy_ms_min"])
            summary[f"{family}/{mode}"] = {"busy_ms_min": best["busy_ms_min"], "stem_ms_at_min": best["stem_ms_at_min"],
                                           "wall_ms_medians": [t["wall_ms_median"] for t in mine]}
    out = {"ab_stem": summary, "device": device_label(device)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3, help="profiled windows per turn")
    ap.add_argument("--steps", type=int, default=3, help="mutual steps per window")
    ap.add_argument("--modes", nargs="*", default=["conv", "pallas"])
    ap.add_argument("--families", nargs="*", default=["fcos", "rcnn"], choices=["fcos", "rcnn"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():  # a measurement: on the card or not at all
        raise SystemExit("ab_stem measures on a card only, and there is no CUDA device")
    return run(torch.device("cuda", 0), args.families, args.modes, args.repeats, args.steps)


if __name__ == "__main__":
    triton_cache_in_checkout()
    main()
