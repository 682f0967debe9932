"""Profile the mutual step of either trainer and print its device time by group.

Builds a recipe's full-width mutual step (seeded weights and batch, the
slice's bias trick so that the teacher feeds NMS and the pseudo labels real
work), runs the burn-in step, the boundary step and WALL_STEPS unprofiled
mutual steps (their host-clock median is the step wall), then --steps
mutual steps under torch.profiler: the device's busy time per step (the sum
of its kernel and copy rows), the share idle against the wall, the kernel
launches per step (all, and the port's own kernels by their counters), the
rows summed by PROFILE_GROUPS and the largest PROFILE_ROWS rows. --out
keeps the Chrome trace (open it in chrome://tracing or Perfetto). On a
card the FCOS steps after the boundary step are replays of its CUDA graph
(engine/step_graph.py), as in training: the rows are the graph's kernels,
and the counters add what a replay launches.

    python -m ubteacher_tpu_torch.tools.profile_step [--rcnn] [--batch 8] \\
        [--canvas 768 1344] [--steps 3] [--out trace.json] [--cpu] [--opts KEY VALUE ...]

With --cpu the rows are the CPU ops' own times (a smoke run at a small
size; no device metric comes from it).
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from .common import BATCH, CANVAS, device_label, step_setup, tool_device, triton_cache_in_checkout

# the rows printed, their names cut to fit a log line, and the groups that
# sum the device rows by the first pattern their name holds
PROFILE_ROWS, PROFILE_NAME_CHARS = 60, 140
PROFILE_GROUPS = (
    ("ROIAlign backward", ("roi_align_backward",)), ("ROIAlign forward", ("roi_align_forward",)),
    ("NMS", ("nms_",)), ("matcher", ("match_",)), ("row scatter", ("scatter_rows",)),
    ("GIoU", ("giou",)), ("focal", ("focal_",)), ("stem", ("stem_conv_pool",)),
    ("convolutions (cuDNN)", ("xmma", "cutlass", "cudnn", "nhwcAddPadding")), ("matmuls", ("nvjet", "gemm")),
    ("memcpy, memset", ("Memcpy", "Memset")), ("sorts", ("Sort", "sort")), ("reductions", ("reduce_kernel",)),
    ("upsample, max-pool", ("upsample", "max_pool")), ("copies and casts", ("copy",)),
    ("gather, scatter, index, cat", ("gather", "scatter", "index", "Cat")),
    ("elementwise", ("elementwise", "Functor", "where", "clamp", "threshold")),
)
# unprofiled mutual steps timed for the step wall, and profiled ones
WALL_STEPS, PROFILED_STEPS = 5, 3


def group_of(name: str) -> str:
    return next((g for g, pats in PROFILE_GROUPS if any(p in name for p in pats)), "other")


def group_rows(rows) -> dict:
    """[(ms, calls, name)] -> {group: (ms, calls)}, summed by group_of."""
    groups = {}
    for ms, calls, name in rows:
        group = group_of(name)
        ms_sum, calls_sum = groups.get(group, (0.0, 0.0))
        groups[group] = (ms_sum + ms, calls_sum + calls)
    return groups


def device_rows(prof, steps: int, on_device: bool = True):
    """The profile's rows per step, largest first: [(ms, calls, name)].
    On a card the device's own rows (kernels, copies; an op's row repeats
    its kernels, so only these are summed; a span, `ubt.*`, shows on the
    device's timeline too, as a user annotation over its kernels, and is
    no row of work); for a CPU run (on_device False) the ops' own CPU time."""
    from torch.autograd import DeviceType

    if on_device:
        rows = [(e.self_device_time_total / steps / 1e3, e.count / steps, e.key) for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
                and not (getattr(e, "is_user_annotation", False) or e.key.startswith("ubt."))]
    else:
        rows = [(e.self_cpu_time_total / steps / 1e3, e.count / steps, e.key)
                for e in prof.key_averages() if e.self_cpu_time_total > 0]
    rows.sort(reverse=True)
    return rows


def timed_steps(mutual, state, batch, n: int):
    """n mutual steps, each timed on the host clock to a synchronize."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, _ = mutual(state, batch)
        sync(batch)
        walls.append((time.perf_counter() - t0) * 1e3)
    return state, walls


def sync(batch) -> None:
    if batch["images_label_k"].is_cuda:
        torch.cuda.synchronize()


def profiled(mutual, state, batch, n: int):
    """n mutual steps under torch.profiler -> (state, profile)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if batch["images_label_k"].is_cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(n):
            state, _ = mutual(state, batch)
        sync(batch)
    return state, prof


def profile_step(label, steps, state, batch, profiled_steps: int = PROFILED_STEPS, out: str = "") -> list:
    """The burn-in step, the boundary step and WALL_STEPS timed mutual
    steps, then `profiled_steps` under torch.profiler: returns (and prints)
    the report's lines; `out` keeps the Chrome trace."""
    from ..ops.kernels import launch_counts, reset_launch_counts

    burnin, mutual = steps
    state, _ = burnin(state, batch)
    state, walls = timed_steps(mutual, state, batch, 1 + WALL_STEPS)  # the boundary step, then the timed ones
    reset_launch_counts()
    state, prof = profiled(mutual, state, batch, profiled_steps)
    if out:
        prof.export_chrome_trace(out)
    ported = {k: v / profiled_steps for k, v in launch_counts().items() if v}
    on_device = batch["images_label_k"].is_cuda
    rows = device_rows(prof, profiled_steps, on_device)
    busy = sum(r[0] for r in rows)
    wall = statistics.median(walls[1:])
    copies = ("Memcpy", "Memset")
    kernels = sum(calls for _, calls, name in rows if not name.startswith(copies))
    h, w = batch["images_label_k"].shape[1:3]
    # a CPU run's rows are ops on the host, not the device's
    busy_label, calls_label = ("device busy", "kernel launches") if on_device else ("CPU ops' own time", "CPU op calls")
    lines = [f"{label}, {batch['images_label_k'].shape[0]}+{batch['images_unlabel_k'].shape[0]} images at {(h, w)}: "
             f"step wall {wall:.2f} ms (median of {WALL_STEPS} unprofiled steps {[round(x, 2) for x in walls[1:]]}); "
             f"{busy_label} {busy:.2f} ms per step over {profiled_steps} profiled steps "
             f"({100 * (1 - busy / wall):.1f}% idle against the wall)",
             f"{calls_label} per step {kernels:.0f} (memcpy and memset rows "
             f"{sum(c for _, c, n in rows if n.startswith(copies)):.0f}); the port's kernels per step {ported}"]
    lines += [f"{ms:10.3f} ms {100 * ms / busy:5.1f}% {calls:7.0f} calls  {group}" for group, (ms, calls) in
              sorted(group_rows(rows).items(), key=lambda kv: -kv[1][0])]
    lines += [f"{ms:10.3f} ms {calls:6.0f} calls  {name[:PROFILE_NAME_CHARS]}" for ms, calls, name in rows[:PROFILE_ROWS]]
    for line in lines:
        print(line, flush=True)
    return lines


def run(rcnn: bool, device, batch: int = BATCH, canvas=CANVAS, profiled_steps: int = PROFILED_STEPS,
        out: str = "", opts=()) -> list:
    """profile_step over a recipe's full-width mutual step (R-CNN or FCOS)."""
    _, steps, state, data = step_setup(rcnn, device, batch, canvas, opts)
    return profile_step("R-CNN mutual step" if rcnn else "FCOS mutual step", steps, state, data, profiled_steps, out)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rcnn", action="store_true")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--canvas", type=int, nargs=2, default=CANVAS)
    ap.add_argument("--steps", type=int, default=PROFILED_STEPS, help="profiled mutual steps")
    ap.add_argument("--out", default="", help="keep the Chrome trace in this file")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the first card)")
    ap.add_argument("--opts", nargs="*", default=[], help="config KEY VALUE overrides")
    args = ap.parse_args(argv)
    device = tool_device(args.cpu)
    print(device_label(device), flush=True)
    return run(args.rcnn, device, args.batch, tuple(args.canvas), args.steps, args.out, args.opts)


if __name__ == "__main__":
    triton_cache_in_checkout()
    main()
