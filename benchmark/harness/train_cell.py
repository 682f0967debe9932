"""A train cell: the port's trainer loop (`train()`, mutual
phase) on the cell's traffic, timed from the harness's side.

Set-up: the JPEG pool and dataset dicts from the seed, the trainer, the
benchmark's weights loaded into its student and teacher, then one mutual
step on every (labeled, unlabeled) canvas pair of the recipe's buckets, so
that no first use falls in the window (cuDNN plans, the allocator, the
Triton kernels), after which the same state is put back to the seed's
weights, an empty optimizer and step 0. Then `train()` runs: its first
`check_steps` iterations (burn-in, the boundary, a mutual step) are the
steps the reference follows; the window opens when they end and closes at
the first iteration end past `--seconds`. The harness ends the loop by
raising from the trainer's metric storage, which the loop calls once an
iteration: the port has no deadline of its own.

With --trace 1 the window runs as without, then `trace_steps` more
iterations run under torch.profiler (the traced window), and the harness
opens `record_function` spans around the calls into the port's layers
(loader, step dispatch, metrics fetch) so that idle gaps can be named."""

from __future__ import annotations

import gc
import math
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from . import cfgs, compare, host, manifest, refrun, trace as trace_mod, traffic as traffic_mod, weights as weights_mod
from .flops import canvases, mutual_flops


class WindowClosed(Exception):
    """Raised from the storage to end the trainer's loop."""


class _Span:
    """A `record_function` span opened and closed by hand (only when
    tracing)."""

    def __init__(self, on: bool):
        self.on = on
        self.ctx = None

    def open(self, name: str):
        if self.on:
            self.ctx = torch.profiler.record_function(name)
            self.ctx.__enter__()

    def close(self):
        if self.ctx is not None:
            self.ctx.__exit__(None, None, None)
            self.ctx = None


class LoaderProxy:
    """The trainer's loader, recording each batch's canvas pair in order."""

    def __init__(self, loader, tracing: bool):
        self.loader = loader
        self.tracing = tracing
        self.pairs: List[tuple] = []

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                span = _Span(self.tracing)
                span.open("harness.loader_next")
                try:
                    batch = next(it)
                finally:
                    span.close()
                self.pairs.append((tuple(batch["images_label_k"].shape[1:3]),
                                   tuple(batch["images_unlabel_k"].shape[1:3])))
                yield batch
        finally:
            it.close()

    def close(self):
        self.loader.close()


class Recorder:
    """The trainer's metric storage, wrapped: it keeps each iteration's
    scalars and end time, takes the correctness snapshots, opens and closes
    the window and the traced window, and ends the loop."""

    def __init__(self, storage, cell: "TrainCell"):
        self.storage = storage
        self.cell = cell
        self.scalars: List[Dict[str, float]] = []
        self.ends: List[float] = []
        self.start: Optional[float] = None
        self.window_end: Optional[float] = None
        self.window_iters = 0
        self.profiler = None
        self.trace_t0 = 0.0
        self.trace_first = 0
        self.fetch = _Span(cell.tracing)
        self.host_samples = ()

    def __getattr__(self, name):
        return getattr(self.storage, name)

    def wrap_step(self, fn):
        def step(state, batch):
            span = _Span(self.cell.tracing)
            span.open("harness.step_dispatch")
            try:
                out = fn(state, batch)
            finally:
                span.close()
            self.fetch.open("harness.metrics_fetch")
            return out
        return step

    def put_scalars(self, **scalars):
        self.fetch.close()
        self.scalars.append(scalars)
        self.storage.put_scalars(**scalars)

    def step(self):
        span = _Span(self.cell.tracing)
        span.open("harness.bookkeeping")
        try:
            self.storage.step()
            self._after_iteration()
        finally:
            span.close()

    def _after_iteration(self):
        now = time.perf_counter()
        i = len(self.ends)
        self.ends.append(now)
        cell = self.cell
        if i < cell.check_steps:
            cell.snapshot(i)
            if i == cell.check_steps - 1:
                self.host_samples = (host.sample(),)
                self.start = time.perf_counter()
            return
        if self.window_end is None:
            if now - self.start >= cell.seconds:
                self.window_end = now
                self.host_samples += (host.sample(),)
                self.window_iters = i - cell.check_steps + 1
                if not cell.tracing:
                    raise WindowClosed
                self._start_profiler(i)
            return
        if self.profiler is not None and i - self.trace_first >= cell.trace_steps:
            if cell.device.type == "cuda":
                torch.cuda.synchronize()
            self.profiler.stop()
            cell.trace_window_s = time.perf_counter() - self.trace_t0
            cell.profile = self.profiler
            self.profiler = None
            raise WindowClosed

    def _start_profiler(self, i: int):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cell.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities)
        self.profiler.start()
        self.trace_first = i
        self.trace_t0 = time.perf_counter()


def _synthetic_batch(lc, uc, bl: int, bu: int, max_gt: int, gen: torch.Generator, device):
    """A device batch at canvases lc / uc with a few valid gt boxes an image
    (the warm-up's: shapes only)."""
    from ubteacher_tpu_torch.structures import PaddedInstances

    def images(b, c):
        return torch.randint(0, 256, (b, c[0], c[1], 3), generator=gen, device=device, dtype=torch.uint8)

    xy = torch.rand((bl, max_gt, 2), generator=gen, device=device) * 200
    wh = 40 + torch.rand((bl, max_gt, 2), generator=gen, device=device) * 200
    mask = torch.zeros((bl, max_gt), dtype=torch.bool, device=device)
    mask[:, :5] = True
    gt = PaddedInstances(
        boxes=torch.cat([xy, xy + wh], -1), classes=torch.zeros((bl, max_gt), dtype=torch.long, device=device),
        scores=torch.ones((bl, max_gt), device=device), box_std=torch.zeros((bl, max_gt, 4), device=device),
        mask=mask,
    )
    return {
        "images_label_k": images(bl, lc), "gt_label": gt,
        "label_hw": torch.tensor(lc, dtype=torch.float32, device=device).expand(bl, 2),
        "images_unlabel_k": images(bu, uc),
        "unlabel_hw": torch.tensor(uc, dtype=torch.float32, device=device).expand(bu, 2),
        "rng": gen,
    }


class TrainCell:
    def __init__(self, workload: Dict, seed: int, seconds: float, tracing: bool, device, cfg_extra=None,
                 mix_extra=None):
        self.workload = workload
        self.conf = manifest.config(workload["config"])
        self.mix = dict(manifest.traffic(workload["traffic"]), **(mix_extra or {}))
        self.seed = seed
        self.seconds = seconds
        self.tracing = tracing
        self.device = torch.device(device)
        self.check_steps = int(self.mix["check_steps"])
        self.trace_steps = int(self.mix["trace_steps"])
        self.cfg_extra = dict({"SEED": seed}, **(cfg_extra or {}))
        self.profile = None
        self.host: Dict[str, float] = {}
        self.trace_window_s = 0.0
        self.snaps: Dict[str, object] = {}

    # -- set-up -------------------------------------------------------------
    def build(self):
        from ubteacher_tpu_torch import config as port_config
        from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

        out_dir = os.path.join(manifest.BENCH_DIR, "_out", self.workload["name"])
        self.cfg = cfgs.build(port_config, self.conf["cfg"], dict(self.cfg_extra, OUTPUT_DIR=out_dir))
        self.pool, self.dicts = traffic_mod.make_pool(self.mix, self.seed, threads=self.cfg.TPU.DATA_THREADS)
        datasets = {"train": self.dicts["label"], "train_unlabel": self.dicts["unlabel"], "test": [], "meta": {}}
        self.trainer = UBTeacherTrainer(self.cfg, datasets=datasets, image_loader=self.pool, device=self.device)
        state = self.trainer.state
        self.w0 = weights_mod.make_weights(weights_mod.param_shapes(state.student), self.conf["init"],
                                           self.seed, self.device)
        self.names = {id(p): n for n, p in state.student.named_parameters()}
        self.warm_up()
        self._reset_state()

    def canvas_pairs(self):
        cs = canvases(self.cfg)
        return [(l, u) for l in cs for u in cs]

    def warm_up(self):
        """One mutual step on every canvas pair, on the trainer's own state
        (put back afterwards) with a generator of its own."""
        t = self.trainer
        gen = torch.Generator(device=self.device).manual_seed(self.seed % 2**62 + 1)
        bl, bu = self.cfg.SOLVER.IMG_PER_BATCH_LABEL, self.cfg.SOLVER.IMG_PER_BATCH_UNLABEL
        t.state.step = self.cfg.SEMISUPNET.BURN_UP_STEP
        for lc, uc in self.canvas_pairs():
            batch = _synthetic_batch(lc, uc, bl, bu, self.cfg.TPU.MAX_GT, gen, self.device)
            t.state, metrics = t.mutual_step(t.state, batch)
            float(metrics["total_loss"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _reset_state(self):
        state = self.trainer.state
        weights_mod.load_into(state.student, self.w0)
        weights_mod.load_into(state.teacher, self.w0)
        state.optimizer.sgd.state.clear()
        state.optimizer.count = 0
        state.step = 0

    # -- the correctness snapshots -----------------------------------------
    def snapshot(self, i: int):
        state = self.trainer.state
        if i == 0:
            self.snaps["grad"] = compare.first_gradient_norms(state, self.names, self.w0)
        if i == self.check_steps - 1:
            self.snaps["change"] = compare.change_norms(state.student, self.w0)
            self.snaps["teacher"] = compare.change_norms(state.teacher, self.w0, self.snaps["change"])

    # -- the run -------------------------------------------------------------
    def run(self) -> Dict:
        t = self.trainer
        rec = Recorder(t.storage, self)
        proxy = LoaderProxy(t.loader, self.tracing)
        t.storage, t.loader = rec, proxy
        t.burnin_step = rec.wrap_step(t.burnin_step)
        t.mutual_step = rec.wrap_step(t.mutual_step)
        closed = False
        try:
            t.train()
        except WindowClosed:
            closed = True
        finally:
            if rec.profiler is not None:
                rec.profiler.stop()
            rec.fetch.close()
            _join_loader_threads()
        if not closed:
            raise RuntimeError("the trainer's loop ended before the window closed")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        first = self.check_steps
        last = first + rec.window_iters  # exclusive
        ends = [rec.start] + rec.ends[first:last]
        table = manifest.flop_table(self.workload["config"])
        run = {
            "window_s": rec.window_end - rec.start,
            "periods_s": [b - a for a, b in zip(ends, ends[1:])],
            "window_scalars": rec.scalars[first:last],
            "images_per_iteration": self.cfg.SOLVER.IMG_PER_BATCH_LABEL + self.cfg.SOLVER.IMG_PER_BATCH_UNLABEL,
            "window_flops": _flops(table, proxy.pairs[first:last]),
            "iterations": len(rec.ends),
            "window_start": rec.start,
            "attempted": rec.window_iters,
            "failed": sum(not math.isfinite(s["total_loss"]) for s in rec.scalars[first:last]),
        }
        if self.profile is not None:
            run["trace"] = trace_mod.reduce_profile(self.profile, self.trace_window_s, self.trace_steps)
            traced = proxy.pairs[rec.trace_first + 1: rec.trace_first + 1 + self.trace_steps]
            run["trace_flops"] = _flops(table, traced)
        self.host = host.window(*rec.host_samples, run["periods_s"], run["images_per_iteration"])
        self.program_readings = {
            "losses": [s["total_loss"] for s in rec.scalars[:self.check_steps]],
            "first_losses": {k: v for k, v in rec.scalars[0].items() if k.startswith("loss_")} if rec.scalars else {},
            "grad": compare.to_host(self.snaps.get("grad", {})),
            "change": compare.to_host(self.snaps.get("change", {})),
            "teacher": compare.to_host(self.snaps.get("teacher", {})),
        }
        return run

    def free(self):
        """Drop the program's state before the reference runs."""
        self.trainer = None
        self.w0 = None
        self.snaps = {}
        self.profile = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, lower_precision: bool = False) -> Dict[str, float]:
        """The compared numbers of the program's first steps against the
        reference's (run after `free`)."""
        ref = self.reference(lower_precision)
        self.details = dict(self.host, **compare.step_gaps(self.program_readings, ref))
        return compare.readings(self.program_readings, ref)

    def reference(self, lower_precision: bool = False) -> Dict:
        return refrun.reference_steps(self.conf, self.cfg_extra, self.seed, self.pool, self.dicts,
                                      self.check_steps, self.device, lower_precision)


Cell = TrainCell


def _flops(table: Dict, pairs) -> Optional[List[int]]:
    """Each iteration's count from the FLOP table, or None where the table
    lacks a pair (a test's small canvases): the readers then read nothing."""
    try:
        return [mutual_flops(table, p) for p in pairs]
    except KeyError:
        return None


def _join_loader_threads(timeout: float = 60.0) -> None:
    """Wait for the loaders' threads to end (the loop's close stops them)."""
    deadline = time.monotonic() + timeout
    for th in threading.enumerate():
        if th is not threading.current_thread() and th.name.startswith(("ubt-batches", "ubt-decode")):
            th.join(max(0.0, deadline - time.monotonic()))
