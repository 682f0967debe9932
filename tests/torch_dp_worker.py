"""Rank-side code of the port's data-parallel tests (test_torch_parallel.py,
test_torch_dp_trainer.py): the functions that
`ubteacher_tpu_torch.parallel.launch` runs on each of several gloo CPU
processes, the same functions the tests call in one process for the
reference, and `start_ranks`, which launches them in a subprocess with a
time limit (a hung rank fails its test; it cannot stop the suite). Imports
torch and the port only, so a rank starts in seconds."""

from __future__ import annotations

import copy
import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.dirname(os.path.abspath(__file__))
# intra-op threads of each rank (tests/torch_parity.py:TEST_TORCH_THREADS)
RANK_THREADS = 2
# each multi-process test's limit, from the launch; a collective waits at most
# COLLECTIVE_TIMEOUT for a peer that stopped answering, so a hung rank fails
# sooner. The ranks share the cores with the suite's other workers: the 2-rank
# steps' ranks need 34-44 s beside six loaded workers on eight cores (about
# 100 CPU seconds), and missed 110 s in the suite's slower runs; 300 s holds
# inside the suite's 1,470 s
RANKS_TIMEOUT = 300.0
COLLECTIVE_TIMEOUT = 60.0


class Ranks:
    """A command (a launcher and its ranks) in a session of its own."""

    def __init__(self, proc: subprocess.Popen, timeout: float):
        self.proc, self.timeout, self.deadline = proc, timeout, time.monotonic() + timeout
        self.started = time.time()
        self.ended = None
        self.out = self.err = self.failure = None

    def join(self) -> None:
        """Wait for the command until the time runs out (then the launcher and
        its ranks are killed); a failure is kept for wait(), with the tail of
        the ranks' stderr, where each rank logs its progress."""
        if self.out is not None:
            return
        try:
            self.out, self.err = self.proc.communicate(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.out, self.err = self.proc.communicate()
            self.failure = (f"the ranks did not finish in time ({self.timeout:.0f} s from their start at "
                            f"{self.started:.1f} s wall); their stderr ends:\n{self.err[-6000:]}")
        else:
            if self.proc.returncode != 0:
                self.failure = f"the ranks failed (rc {self.proc.returncode}):\n{self.err[-6000:]}"
        self.ended = time.time()

    def wait(self) -> str:
        """The launcher's stdout after join(); raises if a rank failed or the
        time ran out."""
        self.join()
        if self.failure:
            raise AssertionError(self.failure)
        return self.out


def start(argv: list, timeout: float, env: dict | None = None) -> Ranks:
    """Start `argv` from the repo's root with PYTHONPATH at the repo and
    tests/ and RANK_THREADS OpenMP threads; returns at once (Ranks.wait
    joins, or kills the whole session after `timeout` seconds)."""
    env = dict(os.environ if env is None else env, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               OMP_NUM_THREADS=str(RANK_THREADS))
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    return Ranks(proc, timeout)


def start_ranks(fn: str, nprocs: int, *args, timeout: float = RANKS_TIMEOUT) -> Ranks:
    """Run torch_dp_worker.<fn>(*args) on `nprocs` gloo CPU ranks through
    parallel.launch."""
    code = ("import torch_dp_worker as w\n"
            "from ubteacher_tpu_torch.parallel import launch\n"
            f"launch(w.{fn}, {nprocs}, backend='gloo', args={args!r}, timeout={COLLECTIVE_TIMEOUT})\n")
    return start([sys.executable, "-c", code], timeout)


def _rank_file(out_dir: str) -> str:
    from ubteacher_tpu_torch.parallel import rank

    return os.path.join(out_dir, f"rank{rank()}.pt")


# --------------------------------------------------------------------------
# allgather_host_rows
# --------------------------------------------------------------------------

GATHER_COUNTS = (2, 0, 3)


def gather_rows(out_dir: str) -> None:
    """Rank r gathers GATHER_COUNTS[r] float64 rows of width 7 (values
    100 r + i), then a float32 column of one value per rank (a 1-D input),
    then no rows on any rank."""
    from ubteacher_tpu_torch.parallel import allgather_host_rows, rank

    r = rank()
    rows = (100.0 * r + np.arange(GATHER_COUNTS[r] * 7, dtype=np.float64)).reshape(-1, 7)
    torch.save({
        "rows": allgather_host_rows(rows),
        "column": allgather_host_rows(np.full((1,), r, np.float32)),
        "empty": allgather_host_rows(np.zeros((0, 5), np.float32)),
    }, _rank_file(out_dir))


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

ROW_KEYS = {"images_label_k": "label", "gt_label": "label", "label_hw": "label",
            "images_unlabel_k": "unlabel", "gt_unlabel": "unlabel", "unlabel_hw": "unlabel"}


def local_batch(batch: dict) -> dict:
    """This rank's rows of a global batch (each stream's images, gt and
    sizes); draws and other keys stay as they are (the steps take their own
    rows of draws for the global batch)."""
    from ubteacher_tpu_torch.parallel import owned_rows

    out = {}
    for k, v in batch.items():
        if k not in ROW_KEYS:
            out[k] = v
            continue
        n = batch["images_label_k" if ROW_KEYS[k] == "label" else "images_unlabel_k"].shape[0]
        own = owned_rows(n)
        out[k] = v.map(lambda x: x[own]) if dataclasses.is_dataclass(v) else v[own]
    return out


def run_steps(case: dict) -> list:
    """Each step of case["steps"] ((which, step, extra batch keys)) from the
    case's initial parameters, on this rank's rows -> [{"metrics": global
    figures (trainer.host_metrics), "student": state_dict, "teacher":
    state_dict}]. `rng_seed` (optional): a CPU generator for the draws. The
    model, its teacher and the optimizer are built once; before each step
    both models take the initial parameters again and the optimizer its
    fresh state (no momentum, count 0)."""
    from ubteacher_tpu_torch.engine.trainer import host_metrics
    from ubteacher_tpu_torch.solver import build_optimizer
    from ubteacher_tpu_torch.tools.common import load_cfg

    cfg = load_cfg(case["opts"], case["cfg_path"])
    if case["kind"] == "fcos":
        from ubteacher_tpu_torch.engine import FCOSTrainState as State, make_fcos_train_steps as make
        from ubteacher_tpu_torch.modeling.fcos_head import build_one_stage_detector as build
    else:
        from ubteacher_tpu_torch.engine.rcnn_trainer import RCNNTrainState as State, make_rcnn_train_steps as make
        from ubteacher_tpu_torch.modeling.rcnn import build_two_stage_rcnn as build
    burnin, mutual = make(cfg)
    model = build(cfg, device="cpu")
    model.load_state_dict(case["params"], strict=True)
    state = State.create(model, build_optimizer(cfg, model))
    fresh = copy.deepcopy(state.optimizer.state_dict())
    out = []
    for which, step, extra in case["steps"]:
        state.student.load_state_dict(case["params"], strict=True)
        state.teacher.load_state_dict(case["params"], strict=True)
        state.optimizer.load_state_dict(copy.deepcopy(fresh))
        state.step = step
        batch = local_batch(dict(case["batch"], **extra))
        if extra.get("rng_seed") is not None:
            batch["rng"] = torch.Generator().manual_seed(extra["rng_seed"])
        state, metrics = (burnin if which == "burnin" else mutual)(state, batch)
        out.append({"metrics": host_metrics(metrics), "student": _copy(state.student.state_dict()),
                    "teacher": _copy(state.teacher.state_dict())})
    return out


def _copy(sd: dict) -> dict:
    return {k: v.clone() for k, v in sd.items()}


def _moved(sd: dict, init: dict) -> dict:
    """sd with None for each tensor bit for bit equal to init's."""
    return {k: None if v.dtype == init[k].dtype and torch.equal(v, init[k]) else v for k, v in sd.items()}


def dp_steps(inputs_path: str, out_dir: str) -> None:
    """Every case of the inputs file through run_steps on this rank. Each
    case's seconds go to stderr as it ends (Ranks.wait shows them on a
    timeout) and into the rank's file under "seconds". A tensor of a
    step's student or teacher that is bit for bit the case's initial value
    is written as None (the test holds the initial values and puts them
    back): the teacher is that at every step, half of the file."""
    from ubteacher_tpu_torch.parallel import rank

    torch.set_num_threads(RANK_THREADS)
    started = time.time()
    print(f"rank {rank()}: started its cases at {started:.1f} s wall", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    cases = torch.load(inputs_path, weights_only=False)
    out, seconds = {}, {"started_at": started, "load": time.perf_counter() - t0}
    for name, case in cases.items():
        t = time.perf_counter()
        print(f"rank {rank()}: case {name} started at {t - t0:.1f} s", file=sys.stderr, flush=True)
        out[name] = [dict(step, **{part: _moved(step[part], case["params"]) for part in ("student", "teacher")})
                     for step in run_steps(case)]
        seconds[name] = time.perf_counter() - t
        print(f"rank {rank()}: case {name} took {seconds[name]:.1f} s", file=sys.stderr, flush=True)
    seconds["total"] = time.perf_counter() - t0
    torch.save(dict(out, seconds=seconds), _rank_file(out_dir))


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------


class RecordingStorage:
    """Every rank's per-iteration scalars, in memory (the trainer's storage
    logs rank 0's only)."""

    iter = 0
    log_period = 20

    def __init__(self):
        self.rows = []

    def put_scalars(self, **scalars) -> None:
        self.rows.append(dict(scalars))

    def step(self) -> None:
        pass

    def close(self) -> None:
        pass


def run_trainer(data_path: str, cfg_path: str, opts: list) -> dict:
    """UBTeacherTrainer on this rank: train() from the seeded model, a
    second trainer resumed from its checkpoint, test() of the teacher -> the
    recorded scalars, both models before and after, the eval metrics, the
    checkpoints' steps and what the resumed state holds differently."""
    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer
    from ubteacher_tpu_torch.tools.common import load_cfg

    data = torch.load(data_path, weights_only=False)
    cfg = load_cfg(opts, cfg_path)
    trainer = UBTeacherTrainer(cfg, datasets=data["datasets"], image_loader=data["images"].__getitem__,
                               device="cpu")
    trainer.storage = RecordingStorage()
    trainer.resume_or_load(resume=False)
    init = {part: {k: v.clone() for k, v in getattr(trainer.state, part).state_dict().items()}
            for part in ("student", "teacher")}
    trainer.train()
    saved = trainer.checkpoint_state()
    resumed = UBTeacherTrainer(cfg, datasets=data["datasets"], image_loader=data["images"].__getitem__,
                               device="cpu")
    resumed.storage = RecordingStorage()
    resumed.resume_or_load(resume=True)
    return {"scalars": trainer.storage.rows, "init": init, "student": trainer.state.student.state_dict(),
            "teacher": trainer.state.teacher.state_dict(), "eval": trainer.test(model="teacher"),
            "checkpoints": trainer.checkpointer.steps(), "resume_differs": state_differs(resumed.checkpoint_state(), saved)}


def state_differs(a: dict, b: dict) -> list:
    """What differs, bit for bit, between two trainers' checkpoint_state():
    both models, the optimizer (momentum buffers, update count), the step
    and the generator's state."""
    bad = [f"{part}.{k}" for part in ("student", "teacher") for k, v in a[part].items()
           if not torch.equal(v, b[part][k])]
    sa, sb = a["optimizer"]["sgd"]["state"], b["optimizer"]["sgd"]["state"]
    if set(sa) != set(sb) or not sa:
        bad.append("optimizer state keys")
    bad += [f"momentum {k}" for k in sa if k in sb
            and not torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"])]
    bad += [k for k in ("step",) if a[k] != b[k]]
    if a["optimizer"]["count"] != b["optimizer"]["count"]:
        bad.append("optimizer count")
    if not torch.equal(a["generator"], b["generator"]):
        bad.append("generator")
    return bad


def dp_trainer(data_path: str, cfg_path: str, opts: list, out_dir: str) -> None:
    """run_trainer on this rank, without "init" in the rank's file (the test
    takes the initial models from its one-process run)."""
    torch.set_num_threads(RANK_THREADS)
    out = run_trainer(data_path, cfg_path, opts)
    del out["init"]
    torch.save(out, _rank_file(out_dir))
