"""Long-run soak: the real trainer loop at the FCOS recipe's geometry, then
kill -9 at a checkpoint and a bitwise resume (port of the JAX package's
tools/soak.py).

A child process runs `engine/trainer.py`'s UBTeacherTrainer on synthetic
COCO-size JPEGs written by this tool (tools/bench_loader.py's writer, both
orientations), through the two-stream loader with its cv2 decode threads,
at the recipe's canvases: 768x1344 and 1344x768 and their 1024x1344 /
1344x1024 buckets, up to 16 (labeled, unlabeled) canvas pairs a phase, 8 + 8
images. It checks:

  * step-time drift: the metrics.json `time` windows (20-step means, as the
    JAX tool reads them) and a per-iteration record (soak_steps.jsonl: the
    phase, both canvases and the step's seconds), whose first use of each
    (phase, canvas pair) in each process is reported as its own outlier row,
    the cost of that pair's first step (cuDNN plans, allocator blocks);
  * host RSS: a daemon thread samples it into soak_rss.jsonl;
  * the checkpoint and eval hooks firing at their periods;
  * kill -9 once a finalized checkpoint at --kill-at or later exists (the
    checkpointer writes a temporary file and renames it, so a checkpoint
    file is a whole one). At every save the child first records an
    order-stable sha256 over what the checkpoint holds (student, teacher and
    optimizer state_dicts, the step, the draws generator's state). This
    process then resumes the run, checks the restored state's hash against
    the killed child's bit for bit, trains on to MAX_ITER and prints the JAX
    tool's summary (`analyze`), with the first-use rows and the RSS slope.

Runs on the first card unless --cpu. --opts KEY VALUE ... overrides the
config last (the CPU test cuts the recipe to 128x128 this way).

Usage:
    python -m ubteacher_tpu_torch.tools.soak [--max-iter 5000] [--kill-at 3000]
        [--burnin 300] [--checkpoint-period 1000] [--eval-period 2000]
        [--workdir DIR] [--rss-period 15] [--timeout S] [--cpu] [--opts KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .common import FCOS_CFG, REPO, device_label, load_cfg, tool_device, triton_cache_in_checkout

POLL_S = 0.2  # the parent's look for a finalized checkpoint
MIN_SLOPE_SPAN = 100  # iterations under an RSS slope


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def _feed(h, obj) -> None:
    """Hash `obj` in an order that depends on its content only: dict items
    by key, sequences in order, a tensor's dtype, shape and bytes."""
    if isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj, key=str):
            h.update(repr(k).encode())
            _feed(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"[")
        for v in obj:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        h.update(repr((str(t.dtype), tuple(t.shape))).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    else:
        h.update(repr(obj).encode())


def state_hash(state) -> str:
    """Order-stable sha256 of a trainer's checkpoint_state()."""
    h = hashlib.sha256()
    _feed(h, state)
    return h.hexdigest()


def build_cfg(args, outdir: str):
    opts = [
        "MODEL.FCOS.NUM_CLASSES", "1",  # the synthetic JPEGs' one class
        "SOLVER.IMG_PER_BATCH_LABEL", "8",
        "SOLVER.IMG_PER_BATCH_UNLABEL", "8",
        "SOLVER.MAX_ITER", str(args.max_iter),
        "SOLVER.CHECKPOINT_PERIOD", str(args.checkpoint_period),
        "SOLVER.BASE_LR", "0.002",  # a backbone from scratch at a short horizon
        "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
        "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
        "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "10.0",
        "SEMISUPNET.BURN_UP_STEP", str(args.burnin),
        "TEST.EVAL_PERIOD", str(args.eval_period),
        "TPU.DATA_THREADS", "4",
        "MODEL.WEIGHTS", "",
        "SEED", "0",
        "OUTPUT_DIR", outdir,
    ]
    return load_cfg(opts + list(args.opts), FCOS_CFG)


def ensure_dataset(workdir: Path):
    """200 COCO-size JPEGs of both orientations and their json (written
    once)."""
    from .bench_loader import write_synthetic_jpegs

    json_path = workdir / "instances.json"
    if not json_path.exists():
        write_synthetic_jpegs(workdir, 200)
    return str(json_path), str(workdir / "images")


def _datasets(workdir: Path) -> dict:
    """The JAX tool's split: 100 labeled, 84 unlabeled, 16 test images."""
    from ..data.coco import load_coco_json

    dicts, meta = load_coco_json(*ensure_dataset(workdir))
    return {"train": dicts[:100], "train_unlabel": dicts[100:184], "test": dicts[184:], "meta": meta}


def _instrument(trainer, outdir: Path, process: str, rss_period: float) -> threading.Event:
    """Per-iteration rows (phase, canvases, seconds) into soak_steps.jsonl
    and an RSS sampler thread into soak_rss.jsonl, both tagged `process`;
    -> the event that stops the sampler."""
    steps_path = outdir / "soak_steps.jsonl"
    last = {}

    def wrap(step, phase):
        def run(state, batch):
            last.update(phase=phase, label=list(batch["images_label_k"].shape[1:3]),
                        unlabel=list(batch["images_unlabel_k"].shape[1:3]))
            return step(state, batch)
        return run

    trainer.burnin_step = wrap(trainer.burnin_step, "burnin")
    trainer.mutual_step = wrap(trainer.mutual_step, "mutual")
    put = trainer.storage.put_scalars

    def put_scalars(**scalars):
        put(**scalars)
        if "time" not in scalars:  # the eval hook's metrics
            return
        row = dict(last, process=process, iteration=trainer.state.step, time=scalars["time"],
                   total_loss=scalars.get("total_loss"))
        with open(steps_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    trainer.storage.put_scalars = put_scalars
    rss_path = outdir / "soak_rss.jsonl"

    stop = threading.Event()

    def sampler():
        t0 = time.time()
        while True:
            rec = {"process": process, "t": round(time.time() - t0, 1), "rss_mb": round(_rss_mb(), 1),
                   "iter": int(trainer.state.step)}
            with open(rss_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if stop.wait(rss_period):
                return

    threading.Thread(target=sampler, daemon=True).start()
    return stop


def _trainer(args, workdir: Path, device):
    from ..engine.trainer import UBTeacherTrainer

    outdir = workdir / "out"
    cfg = build_cfg(args, str(outdir))
    trainer = UBTeacherTrainer(cfg, datasets=_datasets(workdir), device=device)
    trainer.resume_or_load(resume=True)
    return trainer, outdir


def run_child(args) -> None:
    """The training process (killed by the parent after --kill-at)."""
    device = tool_device(args.cpu)
    triton_cache_in_checkout()
    trainer, outdir = _trainer(args, Path(args.workdir), device)
    # the hash of each checkpoint, recorded before the file is in place, so
    # the resuming process can prove it restored what the killed one saved
    hashes_path = outdir / "state_hashes.json"
    hashes = json.loads(hashes_path.read_text()) if hashes_path.exists() else {}
    orig_save = trainer.checkpointer.save

    def hashing_save(step, state):
        hashes[str(step)] = state_hash(state)
        tmp = hashes_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(hashes))
        os.replace(tmp, hashes_path)
        return orig_save(step, state)

    trainer.checkpointer.save = hashing_save
    _instrument(trainer, outdir, "child", args.rss_period)
    trainer.train()


def _checkpoint_steps(outdir: Path) -> list:
    """The finalized checkpoints' steps (a file under its step's name is a
    whole one; one being written has a temporary name)."""
    ckdir = outdir / "checkpoints"
    if not ckdir.exists():
        return []
    return sorted(int(p.name) for p in ckdir.iterdir() if p.name.isdigit())


def _first_use_rows(rows: list) -> list:
    """The first step of each (process, phase, label canvas, unlabel canvas):
    its ms, and its excess over the median of that phase's later steps in
    the same process (None where none follows). `iteration` is the step
    count after the step."""
    out, seen = [], set()
    for i, r in enumerate(rows):
        key = (r["process"], r["phase"], tuple(r["label"]), tuple(r["unlabel"]))
        if key in seen:
            continue
        seen.add(key)
        later = [q["time"] for q in rows[i + 1:] if q["process"] == r["process"] and q["phase"] == r["phase"]]
        out.append({"process": r["process"], "phase": r["phase"], "label": r["label"], "unlabel": r["unlabel"],
                    "iteration": r["iteration"], "ms": round(1e3 * r["time"], 1),
                    "excess_ms": round(1e3 * (r["time"] - statistics.median(later)), 1) if later else None})
    return out


def analyze(outdir: Path, resumed_at: int, hash_ok: bool, killed_at_wall: float) -> dict:
    """metrics.json, soak_steps.jsonl and soak_rss.jsonl -> the soak record:
    the JAX tool's fields (from the 20-step windows), then the per-iteration
    view: each (phase, canvas pair)'s first use, the steady steps' drift and
    the RSS slope."""
    times, iters_with_eval, total_losses = [], [], []
    for line in (outdir / "metrics.json").read_text().splitlines():
        rec = json.loads(line)
        if "time" in rec:
            times.append((rec.get("iteration", len(times)), rec["time"]))
        if any(k.startswith("teacher/") for k in rec):
            iters_with_eval.append(rec.get("iteration"))
        if "total_loss" in rec:
            total_losses.append(rec["total_loss"])
    # a window that holds a first use shows as a >5x-median outlier
    vals = sorted(t for _, t in times)
    med = vals[len(vals) // 2] if vals else 0.0
    thresh = max(5 * med, 5)
    outliers = [(i, round(t, 1)) for i, t in times if t > thresh]
    budget = sum(20.0 * (t - med) for _, t in times if t > thresh)
    steady = [t for _, t in times if t <= thresh]
    first = steady[: max(1, len(steady) // 5)]
    last = steady[-max(1, len(steady) // 5):]
    rss = [json.loads(line) for line in (outdir / "soak_rss.jsonl").read_text().splitlines()]

    rows = [json.loads(line) for line in (outdir / "soak_steps.jsonl").read_text().splitlines()]
    first_use = _first_use_rows(rows)
    first_iters = {(f["process"], f["iteration"]) for f in first_use}
    steady_rows = [r for r in rows if (r["process"], r["iteration"]) not in first_iters]
    fifth = max(1, len(steady_rows) // 5)
    # RSS growth once a process has used every canvas pair it met, over at
    # least MIN_SLOPE_SPAN iterations (a shorter span reads the allocator's
    # warm-up)
    settled = {}
    for f in first_use:
        settled[f["process"]] = max(settled.get(f["process"], 0), f["iteration"])
    rss_iter = [(r["iter"], r["rss_mb"]) for r in rss if r["iter"] >= settled.get(r["process"], 1 << 62)]
    span = max((i for i, _ in rss_iter), default=0) - min((i for i, _ in rss_iter), default=0)
    slope = (float(np.polyfit([i for i, _ in rss_iter], [m for _, m in rss_iter], 1)[0]) * 1000.0
             if span >= MIN_SLOPE_SPAN else None)
    return {
        "soak": "fcos_recipe_canvases",
        "metric_windows": len(times),
        "steps_covered": 20 * len(times),
        "median_step_ms": round(med * 1000, 1),
        "steady_first_fifth_ms": round(float(np.mean(first)) * 1000, 1) if first else None,
        "steady_last_fifth_ms": round(float(np.mean(last)) * 1000, 1) if last else None,
        "compile_outliers": outliers,
        "compile_budget_s": round(budget, 1),
        "rss_start_mb": rss[0]["rss_mb"] if rss else None,
        "rss_end_mb": rss[-1]["rss_mb"] if rss else None,
        "rss_max_mb": max((r["rss_mb"] for r in rss), default=None),
        "eval_iters": iters_with_eval,
        "checkpoints": _checkpoint_steps(outdir),
        "killed_after_s": round(killed_at_wall, 1),
        "resumed_at": resumed_at,
        "resume_hash_bitwise_equal": hash_ok,
        "final_losses_finite": bool(np.isfinite(total_losses[-50:]).all() if total_losses else False),
        # the per-iteration view
        "iterations": len(rows),
        "canvas_pairs_used": len({(r["phase"], tuple(r["label"]), tuple(r["unlabel"])) for r in rows}),
        "first_use": first_use,
        "first_use_excess_s": round(sum(f["excess_ms"] for f in first_use if f["excess_ms"] is not None) / 1e3, 3),
        "steady_median_ms": round(1e3 * statistics.median(r["time"] for r in steady_rows), 1) if steady_rows else None,
        "steady_first_fifth_step_ms": (round(1e3 * float(np.mean([r["time"] for r in steady_rows[:fifth]])), 1)
                                       if steady_rows else None),
        "steady_last_fifth_step_ms": (round(1e3 * float(np.mean([r["time"] for r in steady_rows[-fifth:]])), 1)
                                      if steady_rows else None),
        "rss_slope_mb_per_1k_iters": None if slope is None else round(slope, 1),
    }


def run_parent(args, argv) -> dict:
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    outdir = workdir / "out"
    shutil.rmtree(outdir, ignore_errors=True)  # a fresh run; the JPEGs stay
    ensure_dataset(workdir)  # numpy and cv2 only: the card is the child's

    child_cmd = [sys.executable, "-m", "ubteacher_tpu_torch.tools.soak", "--child"] + list(argv)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    child = subprocess.Popen(child_cmd, env=env, cwd=REPO)
    try:
        while child.poll() is None:
            if args.timeout and time.time() - t0 > args.timeout:
                raise RuntimeError(f"no checkpoint at {args.kill_at} or later within {args.timeout} s of the "
                                   f"child's start")
            steps = _checkpoint_steps(outdir)
            if steps and steps[-1] >= args.kill_at:
                print(f"# killing the child at checkpoint {steps[-1]} (+{time.time() - t0:.0f}s)",
                      file=sys.stderr, flush=True)
                child.send_signal(signal.SIGKILL)
                break
            time.sleep(POLL_S)
        child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    killed_at_wall = time.time() - t0
    if child.returncode != -signal.SIGKILL:
        raise RuntimeError(f"the child ended (rc {child.returncode}) before a checkpoint at {args.kill_at} or later")

    # resume in this process: the restored state must hash to what the
    # killed child recorded at that save, then train to the end
    device = tool_device(args.cpu)
    triton_cache_in_checkout()
    trainer, outdir = _trainer(args, workdir, device)
    resumed_at = trainer.start_iter
    recorded = json.loads((outdir / "state_hashes.json").read_text())
    hash_ok = state_hash(trainer.checkpoint_state()) == recorded.get(str(resumed_at))
    print(f"# resumed at {resumed_at}, bitwise hash equal: {hash_ok}", file=sys.stderr, flush=True)
    stop = _instrument(trainer, outdir, "resumed", args.rss_period)
    try:
        trainer.train()
    finally:
        stop.set()

    summary = analyze(outdir, resumed_at, hash_ok, killed_at_wall)
    summary["max_iter"] = trainer.max_iter
    summary["reached_max_iter"] = trainer.state.step == trainer.max_iter
    summary["device"] = device_label(device)
    (workdir / "soak_summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--max-iter", type=int, default=5000)
    ap.add_argument("--kill-at", type=int, default=3000)
    ap.add_argument("--burnin", type=int, default=300)
    ap.add_argument("--checkpoint-period", type=int, default=1000)
    ap.add_argument("--eval-period", type=int, default=2000)
    ap.add_argument("--workdir", default=os.path.join(REPO, "ubteacher_tpu_torch", "_build", "soak"),
                    help="the JPEGs (kept between runs) and the run's out/ (removed at the start)")
    ap.add_argument("--rss-period", type=float, default=15.0, help="seconds between RSS samples")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="seconds from the child's start to its kill checkpoint (0: no limit)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--opts", nargs="*", default=[], help="config KEY VALUE pairs, applied last")
    ap.add_argument("--child", action="store_true", help="internal: the training process")
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    if args.child:
        return run_child(args)
    return run_parent(args, argv)


if __name__ == "__main__":
    main()
