"""The reduction of a torch.profiler trace to the traced metrics: device
busy time as the union of the device's own rows (kernels, copies, sets)
over the traced window, device time by group, and the idle gaps between
device rows named by what the harness's host was doing.

The groups are a frozen copy of the port's `tools/profile_step.py`
`PROFILE_GROUPS` (the first group whose pattern a row's name holds), so a
later change to the port's tool leaves these sums where they were. The host
ranges come from the harness's own `record_function` spans ("harness.*"),
opened around the calls into the port's layers."""

from __future__ import annotations

from typing import Dict, List, Tuple

GROUPS = (
    ("ROIAlign backward", ("roi_align_backward",)), ("ROIAlign forward", ("roi_align_forward",)),
    ("NMS", ("nms_",)), ("matcher", ("match_",)), ("row scatter", ("scatter_rows",)),
    ("GIoU", ("giou",)), ("focal", ("focal_",)), ("stem", ("stem_conv_pool",)),
    ("convolutions (cuDNN)", ("xmma", "cutlass", "cudnn", "nhwcAddPadding")), ("matmuls", ("nvjet", "gemm")),
    ("memcpy, memset", ("Memcpy", "Memset")), ("sorts", ("Sort", "sort")), ("reductions", ("reduce_kernel",)),
    ("upsample, max-pool", ("upsample", "max_pool")), ("copies and casts", ("copy",)),
    ("gather, scatter, index, cat", ("gather", "scatter", "index", "Cat")),
    ("elementwise", ("elementwise", "Functor", "where", "clamp", "threshold")),
)
# what the host was doing in an idle gap, by the innermost harness span
# that covers the gap's middle
HOST_NAMES = {
    "harness.loader_next": "loader wait",
    "harness.step_dispatch": "step dispatch",
    "harness.metrics_fetch": "metrics fetch",
    "harness.bookkeeping": "harness bookkeeping",
}


def group_of(name: str) -> str:
    return next((g for g, pats in GROUPS if any(p in name for p in pats)), "other")


def _events(prof):
    """(device rows [(start_us, end_us, name)], host spans [(start, end, name)])."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type != DeviceType.CPU:
            # a record_function span shows on the device's timeline too, as
            # a user annotation over its kernels: not a row of work
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("harness.")):
                device.append((start, end, e.name))
        elif e.name.startswith("harness."):
            host.append((start, end, e.name))
    return device, host


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_profile(prof, window_s: float, steps: int) -> Dict:
    """-> {busy_s, window_s, steps, group_ms (per step), device_ops [[group,
    s]], idle_gaps [[what the host did, s]]}. Empty where the trace holds no
    device row."""
    device, host = _events(prof)
    if not device:
        return {}
    busy = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy) / 1e6
    groups: Dict[str, float] = {}
    for s, e, name in device:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + (e - s) / 1e3
    # gaps between the device's rows only: before the first row the
    # profiler itself is starting
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        covering = [h for h in host if h[0] <= mid <= h[1]]
        name = "other host work"
        if covering:
            inner = min(covering, key=lambda h: h[1] - h[0])
            name = HOST_NAMES.get(inner[2], inner[2])
        gaps.append((name, (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    by_group = sorted(groups.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "steps": steps,
        "group_ms": {g: ms / steps for g, ms in groups.items()},
        "device_ops": [[g, ms / 1e3] for g, ms in by_group[:10]],
        "idle_gaps": [[n, s] for n, s in gaps[:10]],
    }
