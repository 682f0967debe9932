"""Run one cell of the benchmark and print its result as the last line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of BENCHMARK.json's `workloads`; its configuration, its
traffic mix, its metrics' readers and its correctness limits are files
found by name under benchmark/ (harness/manifest.py). The mix's `cell`
names the module that drives it, harness/<cell>_cell.py, whose `Cell` is
built with the cell, seed, seconds, trace flag and device and offers
build(), run() -> the readers' run dict, free(), compare() -> the compared
numbers, and `details`. The run needs as many
CUDA devices as the cell asks for, and stops without a result when they are
missing, or when the JAX package or JAX itself is found loaded once the
window has closed. The compared numbers and their limits are the last lines
on standard error and the last key of the result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ubteacher_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the chip path must not load,
    compared whole (`ubteacher_tpu_torch` is not `ubteacher_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def keep_tensorflow_out() -> None:
    """TensorBoard's writer (the trainer's metric storage opens one) imports
    TensorFlow where it is installed, and TensorFlow imports JAX where that
    is installed. TensorBoard's own switch, a `tensorboard.compat.notf`
    module, gives it its TensorFlow stub instead."""
    import types

    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))


def set_cache_dirs(root: str) -> None:
    """The program's kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "benchmark", "_cache", "triton")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t0: float,
             cfg_extra=None, mix_extra=None):
    """-> (result dict, lines for standard error). Runs on `device` (a test
    passes the CPU at a small size; a device metric then reads "not
    measured" and is left out)."""
    keep_tensorflow_out()
    import torch

    from .harness import compare, manifest
    from .harness.peaks import peaks

    man = manifest.manifest()
    cell = manifest.workload(man, workload)
    kind = manifest.traffic(cell["traffic"])["cell"]
    Cell = importlib.import_module(f".harness.{kind}_cell", __package__).Cell
    cell_run = Cell(cell, seed, seconds, trace, device, cfg_extra, mix_extra)
    cell_run.build()
    run = cell_run.run()
    cuda = torch.device(device).type == "cuda"
    run["setup_s"] = run["window_start"] - t0
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if cuda:
        run["memory_peak_bytes"] = dev["memory_peak_bytes"]
        p = peaks(dev["kind"])
        run["peak_flops"], run["peak_fp32_flops"], run["peak_bytes_s"] = p["bf16_flops"], p["fp32_flops"], p["hbm_bytes_s"]
    metrics = {}
    for m in manifest.cell_metrics(man, workload, trace):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded once the window closed: {', '.join(found)}")
    result = {"correct": False, "attempted": run["attempted"], "failed": run["failed"], "metrics": metrics,
              "device": dev}
    tr = run.get("trace")
    if trace and tr:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    cell_run.free()
    numbers = cell_run.compare()
    limits = manifest.limits(workload)
    result["correct"] = compare.judge(numbers, limits)
    result["checks"] = compare.checks(numbers, limits)
    details = [f"{k} {v!r}" for k, v in dict(cell_run.details, **compare.uncompared(numbers, limits)).items()]
    return result, details + compare.lines(numbers, limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(root, "ubteacher_tpu_torch")):
        print("the port (ubteacher_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    set_cache_dirs(root)
    import torch

    # one intra-op CPU thread, as torchrun gives every trainer process
    # (OMP_NUM_THREADS=1): the loop's CPU tensors are small, and eight OpenMP
    # workers spinning beside the loader's eight decode threads on an
    # eight-core host made runs of one seed differ by up to 30%
    torch.set_num_threads(1)
    from .harness import manifest

    cell = manifest.workload(manifest.manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"loaded once the window closed: {', '.join(found)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
