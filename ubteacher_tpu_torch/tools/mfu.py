"""Model FLOPs of one mutual step of each trainer -> the MFU basis.

Counts the FLOPs of ONE mutual step (teacher forward, dual pseudo-labeling,
student forward and backward over labeled strong + weak and unlabeled
strong, SGD) by running the port's own `mutual_step` under
`torch.utils.flop_counter.FlopCounterMode`: convolutions and matmuls
counted from their shapes, 2 x MAC, forward and backward as autograd runs
them (on a card the step runs eagerly under the mode, not as a replay of
its CUDA graph: engine/step_graph.py). The hand-written kernels count 0, as the Pallas calls do in XLA's
cost analysis; elementwise work counts 0 (the JAX package's count, from
pre-optimization HLO, holds it). Cross-checked against an analytic estimate
scaled from the published ResNet-50 cost (the JAX tool's), and written to
`ubteacher_tpu_torch/tools/flops_mutual.json`:

    mfu = flops_per_step / step_seconds / peak_bf16

On a card it also times --time mutual steps (host clock around work ending
in a synchronize) and prints their MFU against the card's dense-bf16 peak
(989 TFLOP/s for an H100 SXM, 756 for a PCIe card, chosen by its name).

    python -m ubteacher_tpu_torch.tools.mfu [--canvas 768 1344] [--batch 8] \\
        [--time 5] [--out ubteacher_tpu_torch/tools/flops_mutual.json] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from .common import CANVAS, BATCH, device_label, peak_bf16, step_setup, tool_device, triton_cache_in_checkout

# the JAX package's counts at 768x1344, 8 + 8 (its tools/flops_mutual.json)
JAX_FLOPS = {"fcos": 30947017752576.0, "rcnn": 30790664585216.0}
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flops_mutual.json")


def count_step_flops(step, state, batch):
    """-> (FLOPs of one call of step(state, batch) by FlopCounterMode, the
    new state, {op name: FLOPs})."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        state, _ = step(state, batch)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return int(counter.get_total_flops()), state, by_op


def analytic_estimate(canvas, batch: int, rcnn: bool) -> float:
    """Order-of-magnitude cross-check from published per-image conv costs.

    Anchor: ResNet-50 forward is ~4.1 GFLOP at 224x224 (He et al. 2015,
    table 1: 3.8 GMAC class-agnostic convention; the commonly cited conv
    2*MAC count is ~8.2 GFLOP -- we use 2*MAC = 8.2e9 to match the flops
    convention, which counts multiply and add separately). Backbone cost
    scales linearly with pixel area. FPN + FCOS head towers at the bench
    config roughly double the backbone cost per image (4 conv+GN towers x
    2 branches x 256ch at strides 8..128 sum to ~backbone-scale); for
    RCNN, FPN + RPN + per-roi heads add ~60%. Backward = 2x forward.

    The estimate deliberately stays coarse (+/-40%): its job is to catch
    an order-of-magnitude counting bug, not to re-derive the count.
    """
    h, w = canvas
    area_scale = (h * w) / (224.0 * 224.0)
    backbone_fwd = 8.2e9 * area_scale
    head_factor = 2.0 if not rcnn else 1.6
    per_image_fwd = backbone_fwd * head_factor
    # mutual step: student fwd+bwd (3x fwd cost) on 2*batch labeled views +
    # batch unlabeled strong; teacher fwd on batch unlabeled
    student_images = 3 * batch
    teacher_images = batch
    return per_image_fwd * (3.0 * student_images + 1.0 * teacher_images)


def mutual_step_ms(mutual, state, batch, steps: int):
    """Host-clock ms of `steps` mutual steps, each ending in a synchronize."""
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, _ = mutual(state, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out, state


def measure(rcnn: bool, device, batch: int = BATCH, canvas=CANVAS, timed_steps: int = 0, opts=()) -> dict:
    """One trainer's count (after the burn-in and boundary steps) and, with
    timed_steps on a card, the MFU of that many more mutual steps."""
    family = "rcnn" if rcnn else "fcos"
    _, (burnin, mutual), state, data = step_setup(rcnn, device, batch, canvas, opts)
    state, _ = burnin(state, data)
    state, _ = mutual(state, data)  # the boundary step: the teacher starts as the student
    flops, state, by_op = count_step_flops(mutual, state, data)
    est = analytic_estimate(canvas, batch, rcnn)
    out = {
        "flops_per_step": flops,
        "by_op": by_op,
        "analytic_estimate": est,
        "counted_over_analytic": round(flops / est, 3),
    }
    if tuple(canvas) == CANVAS and batch == BATCH:
        out["counted_over_jax"] = round(flops / JAX_FLOPS[family], 3)
    if timed_steps and device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        part, peak = peak_bf16(name)
        ms, state = mutual_step_ms(mutual, state, data, timed_steps)
        med = statistics.median(ms)
        out.update(step_ms=[round(m, 2) for m in ms], step_ms_median=round(med, 2), peak_part=part,
                   peak_flops=peak, mfu=flops / (med / 1e3) / peak)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--canvas", type=int, nargs=2, default=CANVAS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--time", type=int, default=5, help="mutual steps timed for the MFU (card only)")
    ap.add_argument("--families", nargs="*", default=["fcos", "rcnn"], choices=["fcos", "rcnn"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true", help="count on the CPU (default: the first card)")
    ap.add_argument("--opts", nargs="*", default=[], help="config KEY VALUE overrides")
    args = ap.parse_args(argv)
    device = tool_device(args.cpu)
    out = {
        "canvas": list(args.canvas),
        "batch_label": args.batch,
        "batch_unlabel": args.batch,
        "device": device_label(device),
        "note": ("flops of ONE mutual step by torch.utils.flop_counter.FlopCounterMode around the port's "
                 "mutual_step: convolutions and matmuls from their shapes, 2*MAC, forward and backward; "
                 "hand-written kernels and elementwise work count 0; analytic = coarse published-R50 "
                 "scaling cross-check (ubteacher_tpu_torch/tools/mfu.py)"),
    }
    for family in args.families:
        r = measure(family == "rcnn", device, args.batch, tuple(args.canvas), args.time, args.opts)
        out[family] = r
        line = (f"{family}: counted {r['flops_per_step'] / 1e12:.3f} TFLOP/step, analytic "
                f"~{r['analytic_estimate'] / 1e12:.2f}, ratio {r['counted_over_analytic']:.3f}")
        if "counted_over_jax" in r:
            line += f", over the JAX count {r['counted_over_jax']:.3f}"
        if "mfu" in r:
            line += (f"; mutual step median {r['step_ms_median']:.2f} ms of {r['step_ms']}: MFU "
                     f"{100 * r['mfu']:.2f}% of {r['peak_flops'] / 1e12:.0f} TFLOP/s ({r['peak_part']}, {out['device']})")
        print(line, flush=True)
        for op, n in sorted(r["by_op"].items(), key=lambda kv: -kv[1]):
            print(f"  {op}: {n / 1e12:.3f} TFLOP", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out, flush=True)
    return out


if __name__ == "__main__":
    triton_cache_in_checkout()
    main()
