"""Metric storage and writers (PyTorch port of ubteacher_tpu.utils.events).

Equivalent of detectron2's EventStorage + PeriodicWriter stack as the
reference uses them (reference: trainer.py:144, 431-466, 551): scalars
accumulate per step; the console and JSON-lines writers flush the means
every `log_period` steps, to OUTPUT_DIR/metrics.json with the keys the JAX
package writes. The trainer hands over each step's metrics as host floats
fetched in one transfer.

Spans (`span`) time the phases of the trainer's loop, its steps and its
loader: each adds to SPAN_STATS, and while a torch profiler records on its
thread, it also puts its range into the profiler's trace.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

logger = logging.getLogger("ubteacher_tpu_torch")

# every span of this process so far: name -> [count, wall seconds, CPU
# seconds of the thread that ran it]; the loader's threads write to it too
SPAN_STATS: Dict[str, List[float]] = {}
_SPAN_LOCK = threading.Lock()


class span:
    """`with span(name):` adds one count, the wall seconds
    (time.perf_counter) and the calling thread's CPU seconds
    (time.thread_time) to SPAN_STATS[name]. While a torch profiler records
    on the calling thread (the one that started it: the loop's, not the
    loader's), it also opens `record_function(name)`, so the range lands in
    the trace on the profiler's clock, beside the device rows its launches
    feed. Spans mark phases, never single ops: a span costs about
    ten microseconds."""

    __slots__ = ("name", "_rf", "_t0", "_c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._rf = None
        if torch.autograd._profiler_enabled():  # on this thread
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._c0 = time.thread_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        wall = time.perf_counter() - self._t0
        cpu = time.thread_time() - self._c0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        with _SPAN_LOCK:
            stats = SPAN_STATS.setdefault(self.name, [0, 0.0, 0.0])
            stats[0] += 1
            stats[1] += wall
            stats[2] += cpu


def span_totals() -> Dict[str, Tuple[int, float, float]]:
    """A copy of SPAN_STATS: name -> (count, wall s, CPU s)."""
    with _SPAN_LOCK:
        return {k: tuple(v) for k, v in SPAN_STATS.items()}


class EventStorage:
    def __init__(self, output_dir: str, log_period: int = 20, tensorboard: bool = True):
        self.output_dir = output_dir
        self.log_period = log_period
        self._buffer: Dict[str, list] = defaultdict(list)
        self._iter = 0
        self._json_path = os.path.join(output_dir, "metrics.json")
        os.makedirs(output_dir, exist_ok=True)
        self._t_last = time.perf_counter()
        # TensorBoard writer, like D2's default_writers TensorboardXWriter
        # (reference: trainer.py:551 -> PeriodicWriter); optional dependency
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None  # the optional dependency is absent: off
            if SummaryWriter is not None:
                try:
                    self._tb = SummaryWriter(log_dir=os.path.join(output_dir, "tensorboard"))
                except Exception as e:  # a broken install must not stop training
                    logger.warning("TensorBoard writer disabled: %s", e)
                    self._tb = None

    @property
    def iter(self) -> int:
        return self._iter

    def put_scalars(self, **scalars) -> None:
        for k, v in scalars.items():
            self._buffer[k].append(float(v))

    def step(self) -> None:
        self._iter += 1
        if self._iter % self.log_period == 0:
            self._flush()

    def _flush(self) -> None:
        now = time.perf_counter()
        sec_per_iter = (now - self._t_last) / max(self.log_period, 1)
        self._t_last = now
        means = {k: sum(v) / len(v) for k, v in self._buffer.items() if v}
        means["iteration"] = self._iter
        means["sec_per_iter"] = sec_per_iter
        with open(self._json_path, "a") as f:
            f.write(json.dumps(means) + "\n")
        if self._tb is not None:
            for k, v in means.items():
                self._tb.add_scalar(k, v, self._iter)
            # the writer's event thread flushes only every ~120 s; flush per
            # log period so short or crashed runs keep their scalars
            self._tb.flush()
        loss_str = "  ".join(
            f"{k}: {v:.4g}" for k, v in sorted(means.items()) if k.startswith(("loss", "total"))
        )
        logger.info("iter: %d  %s  sec/iter: %.3f", self._iter, loss_str, sec_per_iter)
        self._buffer.clear()

    def close(self) -> None:
        """Flush pending scalars and close the TensorBoard writer."""
        if self._buffer:
            self._flush()
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class NullEventStorage:
    """The storage of every rank but the first: metrics, logs and checkpoints
    are rank 0's (reference: comm.is_main_process gating, trainer.py:527)."""

    iter = 0
    log_period = 20

    def put_scalars(self, **scalars) -> None:
        pass

    def step(self) -> None:
        pass

    def close(self) -> None:
        pass


def setup_logger(output_dir: str | None = None) -> logging.Logger:
    """The port's logger: one console handler, and a log.txt file handler
    per output directory (a later call with a new directory still adds its
    file handler)."""
    lg = logging.getLogger("ubteacher_tpu_torch")
    lg.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S")
    if not any(type(h) is logging.StreamHandler for h in lg.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        lg.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(output_dir, "log.txt"))
        if not any(isinstance(h, logging.FileHandler) and getattr(h, "baseFilename", None) == path
                   for h in lg.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            lg.addHandler(fh)
    return lg
