"""Host-side trainer: data, model, steps, checkpoints and eval wired into a
run (PyTorch port of ubteacher_tpu.engine.trainer).

Equivalent of UBTeacherTrainer (reference: ubteacher/engine/trainer.py:
38-608) minus what runs inside the steps (EMA, pseudo-labeling, strong
augmentation, loss weighting: engine/fcos_trainer.py, rcnn_trainer.py). On
the host stays the loop: iterate the two-stream loader, dispatch burn-in or
mutual step on the iteration (reference: trainer.py:191/212), log metrics,
checkpoint periodically, evaluate.

The trainer runs on `device` (default: the rank's card, cuda:LOCAL_RANK;
there is no CPU fallback, a CPU run must ask for it). Per iteration:
  * the step is dispatched on a batch that is already on the device;
  * while it runs, the next batch is taken from the loader, copied into
    pinned host memory and sent to the device with non_blocking=True on a
    copy stream (the JAX trainer's one-batch device prefetch);
  * all device metrics come back in one transfer of one stacked tensor, the
    iteration's only wait for the device.
Under data parallelism (parallel/dist.py: one process per card, the batch
sizes global) each rank loads and steps on its own rows; the stacked
metrics are summed over the ranks in one all_reduce before the fetch, so
rank 0 logs the global figures; rank 0 alone logs, writes metrics,
checkpoints and visualizations; test() splits the test set by rank and the
evaluator gathers the detections, so every rank returns the same metrics.
The strong-augmentation (and R-CNN sampling) draws come from one
torch.Generator on the device, seeded SEED + 17 (the JAX trainer's
PRNGKey(SEED + 17)), handed to each step as batch["rng"]; its state is
checkpointed with the model and optimizer.

Metrics per iteration (metrics.json, the JAX trainer's keys): the step's
losses and counts; `time`, host seconds from the step's dispatch to its
metrics on the host (the next batch's fetch and copy overlap the step inside
it); `data_time`, host seconds spent taking batches from the loader and
starting their copies; `corrupt_rows_total`, samples replaced so far; and
what the iteration's spans (utils/events.py `span`, named `ubt.*`) read:
`queue_wait_time` (blocked on the loader's queue), `h2d_time` (pinning the
next batch and starting its copy), `dispatch_time` (the step call),
`backward_time` (its backward), `fetch_time` (the metrics fetch: the
iteration's wait for the device), in wall seconds; `dispatch_cpu_time`, the
loop thread's CPU seconds in the step outside backward (whose kernels
autograd's own thread enqueues); `loader_cpu_time` and `loader_images`, the
decode threads' CPU seconds reading and weak-augmenting images, and how many;
`loader_queue_depth`, batches ready when the loop asked for one.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import TSCheckpointer
from ..checkpoint.torch_weights import (
    TrackingStateDict,
    cast_like,
    load_pretrained_backbone,
    load_torch_state_dict,
    split_ensemble_state,
)
from ..data import loader as loader_mod
from ..data.coco import divide_label_unlabel, load_coco_json, load_coco_unlabel_json
from ..data.loader import TestDataLoader, TwoStreamDataLoader
from ..evaluation import inference_on_dataset
from ..parallel import all_reduce_sum, broadcast_module, is_main_process, local_rank, rank, world_size
from ..solver import build_optimizer
from ..structures import PaddedInstances
from ..utils.events import EventStorage, NullEventStorage, setup_logger, span, span_totals
from .fcos_trainer import FCOSTrainState, make_fcos_train_steps

logger = logging.getLogger("ubteacher_tpu_torch")


def auto_scale_workers(cfg, num_workers: int):
    """D2 DefaultTrainer.auto_scale_workers semantics (reference:
    trainer.py:46, 620): when SOLVER.REFERENCE_WORLD_SIZE > 0, linearly
    rescale batch sizes, LR and schedule to the actual worker count."""
    old = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old == 0 or old == num_workers:
        return cfg
    cfg = cfg.clone()
    frozen = cfg.is_frozen()
    cfg.defrost()
    scale = num_workers / old
    cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
    cfg.SOLVER.IMG_PER_BATCH_LABEL = int(round(cfg.SOLVER.IMG_PER_BATCH_LABEL * scale))
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = int(round(cfg.SOLVER.IMG_PER_BATCH_UNLABEL * scale))
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.STEPS = tuple(int(round(s / scale)) for s in cfg.SOLVER.STEPS)
    cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
    cfg.SOLVER.CHECKPOINT_PERIOD = int(round(cfg.SOLVER.CHECKPOINT_PERIOD / scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
    if frozen:
        cfg.freeze()
    return cfg


def verify_results(cfg, results: Dict[str, float]) -> bool:
    """Compare eval results against cfg.TEST.EXPECTED_RESULTS entries of the
    form [metric, expected, tolerance] (reference: trainer.py:133-135 via
    D2 verify_results)."""
    ok = True
    for metric, expected, tolerance in cfg.TEST.EXPECTED_RESULTS:
        actual = results.get(metric, float("nan"))
        if not (abs(actual - expected) <= tolerance):
            ok = False
            logger.error("verify_results FAILED: %s = %.4f, expected %.4f +/- %.4f",
                         metric, actual, expected, tolerance)
        else:
            logger.info("verify_results ok: %s = %.4f (expected %.4f +/- %.4f)",
                        metric, actual, expected, tolerance)
    return ok


def resolve_device(device=None) -> torch.device:
    """None -> the rank's card (cuda:LOCAL_RANK). A CUDA device without a
    card raises: the trainer never carries on on the CPU unless asked to."""
    device = torch.device("cuda", local_rank()) if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}; pass device='cpu' (MODEL.DEVICE cpu) to run on the CPU")
    return device


class _DeviceBatches:
    """Host batches -> the device: numpy arrays (and CPU tensors) are copied
    into pinned memory and sent with non_blocking=True on a copy stream;
    `take` makes the compute stream wait for that copy. On the CPU the
    arrays are wrapped without a copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def _tensor(self, x) -> torch.Tensor:
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        if not self.cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _value(self, v):
        if isinstance(v, (np.ndarray, torch.Tensor)):
            return self._tensor(v)
        if isinstance(v, PaddedInstances):
            out = v.map(self._tensor)
            out.classes = out.classes.long()  # the loader ships int32, as the JAX loader does
            return out
        return v

    def send(self, batch: Dict[str, Any]):
        """Start the copy of `batch`; returns a handle for `take`."""
        if not self.cuda:
            return {k: self._value(v) for k, v in batch.items()}, None
        with torch.cuda.stream(self.stream):
            out = {k: self._value(v) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def take(self, handle) -> Dict[str, Any]:
        """The batch on the device, ordered after its copy on the current
        stream (and kept alive for it by the caching allocator)."""
        batch, done = handle
        if done is None:
            return batch
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        for v in batch.values():
            for t in _tensors(v):
                t.record_stream(current)
        return batch


def _tensors(v) -> Iterator[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        yield v
    elif dataclasses.is_dataclass(v):
        for f in dataclasses.fields(v):
            yield from _tensors(getattr(v, f.name))


# metrics every rank computes alike (not shares of a global figure)
REPLICATED_METRICS = ("ema_rate_1000x",)


def span_scalars(before: Dict, after: Dict) -> Dict[str, float]:
    """The iteration's span figures: the change of `span_totals()` from
    `before` to `after` (see the module's docstring)."""
    def delta(name: str, i: int) -> float:
        return after.get(name, (0, 0.0, 0.0))[i] - before.get(name, (0, 0.0, 0.0))[i]

    return {
        "queue_wait_time": delta("ubt.loader.queue_wait", 1),
        "h2d_time": delta("ubt.train.h2d", 1),
        "dispatch_time": delta("ubt.step", 1),
        "backward_time": delta("ubt.step.backward", 1),
        "fetch_time": delta("ubt.train.metrics_fetch", 1),
        "dispatch_cpu_time": delta("ubt.step", 2) - delta("ubt.step.backward", 2),
        "loader_cpu_time": delta("ubt.loader.read", 2) + delta("ubt.loader.augment", 2),
        "loader_images": delta("ubt.loader.read", 0),
        "loader_queue_depth": float(loader_mod.PREFETCH["ready"]),
    }


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Step metrics -> floats of the global batch. The losses (shares) and
    counts go into one stacked float64 tensor, summed over the ranks by one
    all_reduce and fetched by one copy (the step's only sync); the
    replicated ones (ema_rate_1000x, computed on the host) are read
    directly."""
    summed = [k for k in metrics if k not in REPLICATED_METRICS]
    fetched: Dict[str, float] = {}
    if summed:
        values = all_reduce_sum(torch.stack([metrics[k].reshape(()).double() for k in summed])).cpu()
        fetched = dict(zip(summed, values.tolist()))
    return {k: fetched[k] if k in fetched else float(v) for k, v in metrics.items()}


class UBTeacherTrainer:
    """FCOS semi-supervised trainer (SEMISUPNET.Trainer == 'ubteacher')."""

    def __init__(self, cfg, datasets: Optional[Dict] = None, image_loader=None, device=None):
        """datasets: optional {'train': dicts, 'train_unlabel': dicts,
        'test': dicts, 'meta': meta} in place of the COCO files under
        $COCO_ROOT. image_loader: file name -> (H, W, 3) uint8 BGR, in place
        of reading files with cv2. device: default the first card."""
        self.device = resolve_device(device)
        cfg = auto_scale_workers(cfg, world_size())
        self.cfg = cfg
        if is_main_process():
            setup_logger(cfg.OUTPUT_DIR)
            self.storage = EventStorage(cfg.OUTPUT_DIR)
        else:
            self.storage = NullEventStorage()

        if datasets is None:
            datasets = self._load_datasets(cfg)
        self.datasets = datasets
        label_dicts = datasets["train"]
        unlabel_dicts = datasets.get("train_unlabel")
        if unlabel_dicts is None:
            # COCO-standard protocol: split train by the dataseed file
            label_dicts, unlabel_dicts = divide_label_unlabel(
                label_dicts, cfg.DATALOADER.SUP_PERCENT, cfg.DATALOADER.RANDOM_DATA_SEED,
                cfg.DATALOADER.RANDOM_DATA_SEED_PATH,
            )
        seed = max(cfg.SEED, 0)
        self.loader = TwoStreamDataLoader(cfg, label_dicts, unlabel_dicts, seed=seed, image_loader=image_loader)
        self._image_loader = image_loader

        model = self._build_model(cfg, torch.Generator().manual_seed(seed))
        weights = cfg.MODEL.WEIGHTS
        is_torch_full = weights.endswith((".pth", ".pt"))
        if weights and os.path.isfile(weights) and not is_torch_full:
            logger.info("loading pretrained backbone from %s", weights)
            load_pretrained_backbone(model, weights, cfg.MODEL.RESNETS.DEPTH)
        elif weights and not is_torch_full:
            logger.warning("MODEL.WEIGHTS=%s not found on disk; training from scratch", weights)
        self.state = FCOSTrainState.create(model, build_optimizer(cfg, model))
        self.burnin_step, self.mutual_step = self._make_steps(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)
        self.checkpointer = TSCheckpointer(cfg.OUTPUT_DIR)
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self._vis_fns: Dict[str, Callable] = {}  # VIS_PERIOD's decode functions, made at first use

    @staticmethod
    def _load_datasets(cfg) -> Dict:
        """DATASETS.* as the COCO json files under $COCO_ROOT (datasets/coco
        by default, like detectron2's ./datasets layout)."""
        root = os.environ.get("COCO_ROOT", "datasets/coco")
        train, meta = load_coco_json(os.path.join(root, "annotations/instances_train2017.json"),
                                     os.path.join(root, "train2017"))
        test, _ = load_coco_json(os.path.join(root, "annotations/instances_val2017.json"),
                                 os.path.join(root, "val2017"))
        out = {"train": train, "test": test, "meta": meta}
        if cfg.DATASETS.CROSS_DATASET:
            out["train_unlabel"] = load_coco_unlabel_json(
                os.path.join(root, "annotations/image_info_unlabeled2017.json"),
                os.path.join(root, "unlabeled2017"),
            )
        return out

    # -- checkpoints --------------------------------------------------------
    def checkpoint_state(self) -> Dict[str, Any]:
        """What a checkpoint holds: both models, the optimizer (momentum
        buffers and update count), the step and the generator's state."""
        return {
            "student": self.state.student.state_dict(),
            "teacher": self.state.teacher.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
            "step": self.state.step,
            "generator": self.generator.get_state(),
        }

    def _restore(self, ckpt: Dict[str, Any]) -> None:
        self.state.student.load_state_dict(ckpt["student"])
        self.state.teacher.load_state_dict(ckpt["teacher"])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        self.state.step = int(ckpt["step"])
        self.generator.set_state(ckpt["generator"])

    def resume_or_load(self, resume: bool = True) -> None:
        """resume: restore the newest checkpoint under OUTPUT_DIR, if any
        (every rank reads the same file). Otherwise a MODEL.WEIGHTS .pth/.pt
        is loaded as a reference checkpoint. The loader restarts from its
        seed either way, as the JAX trainer's does. Then both models are
        rank 0's on every rank."""
        ckpt = self.checkpointer.resume_or_load(resume)
        if ckpt is not None:
            self._restore(ckpt)
        self.start_iter = self.state.step
        if resume and self.start_iter > 0:
            logger.info("resumed at iteration %d", self.start_iter)
        else:
            w = self.cfg.MODEL.WEIGHTS
            if w and w.endswith((".pth", ".pt")):
                if not os.path.isfile(w):
                    raise FileNotFoundError(f"MODEL.WEIGHTS not found: {w}")
                self._load_torch_checkpoint(w)
        broadcast_module(self.state.student)
        broadcast_module(self.state.teacher)

    def _load_torch_checkpoint(self, path: str) -> None:
        """MODEL.WEIGHTS pointing at a reference checkpoint: an
        EnsembleTSModel checkpoint fills both teacher and student, a bare
        detector state dict the student only, like DetectionTSCheckpointer
        (reference: train_net.py:37-51, detection_checkpoint.py:10-89).
        Reference parameters that no port parameter takes are logged."""
        sd = load_torch_state_dict(path)
        parts = split_ensemble_state(sd)
        convert = self._torch_converter()
        init = self.state.student.state_dict()

        def load(name: str, part: Dict) -> None:
            tracked = TrackingStateDict(part)
            getattr(self.state, name).load_state_dict(cast_like(convert(tracked), init))
            unused = tracked.unused()
            if unused:
                logger.warning("%s: %d reference parameters unused, e.g. %s", name, len(unused), unused[:4])

        if parts["teacher"] or parts["student"]:
            for name in ("teacher", "student"):
                if parts[name]:
                    load(name, parts[name])
                    logger.info("loaded %s weights from %s", name, path)
                else:
                    logger.warning("checkpoint has no %s weights", name)
        else:
            load("student", sd)
            logger.info("loaded bare detector state dict into the student from %s", path)

    # -- the loop -----------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        burn_up = cfg.SEMISUPNET.BURN_UP_STEP
        logger.info("starting training at iter %d (burn-in until %d, max %d)",
                    self.start_iter, burn_up, self.max_iter)
        # UBT_PROFILE_DIR: a torch.profiler trace of steps 10..20, the
        # counterpart of the JAX trainer's jax.profiler hook
        profile_dir = os.environ.get("UBT_PROFILE_DIR", "")
        profiler = None
        copier = _DeviceBatches(self.device)
        data_iter: Iterator = iter(self.loader)

        def fetch():
            batch = next(data_iter)
            batch["rng"] = self.generator
            with span("ubt.train.h2d"):
                return copier.send(batch)

        pending = None
        totals = span_totals()
        try:
            for it in range(self.start_iter, self.max_iter):
                if profile_dir and it == self.start_iter + 10:
                    profiler = self._start_profiler()
                if profiler is not None and it == self.start_iter + 20:
                    self._stop_profiler(profiler, profile_dir)
                    profiler = None
                t_data = time.perf_counter()
                if pending is None:
                    pending = fetch()
                with span("ubt.train.iteration"):
                    batch = copier.take(pending)
                    data_time = time.perf_counter() - t_data
                    # host-side branch on the iteration, like the reference's
                    # python `if` (trainer.py:191/212)
                    t_step = time.perf_counter()
                    step = self.burnin_step if it < burn_up else self.mutual_step
                    with span("ubt.step"):
                        self.state, metrics = step(self.state, batch)
                    # the next batch's fetch and copy overlap the step on the device
                    t_data = time.perf_counter()
                    pending = fetch() if it + 1 < self.max_iter else None
                    data_time += time.perf_counter() - t_data
                    with span("ubt.train.metrics_fetch"):
                        scalars = host_metrics(metrics)
                    # the reference's hooks.IterationTimer "time" (trainer.py:509)
                    scalars["time"] = time.perf_counter() - t_step
                    scalars["data_time"] = data_time
                    scalars["corrupt_rows_total"] = float(loader_mod.DECODE_STATS["corrupt"])
                    now = span_totals()
                    scalars.update(span_scalars(totals, now))
                    totals = now
                    with span("ubt.train.bookkeeping"):
                        self.storage.put_scalars(**scalars)
                        if cfg.VIS_PERIOD and (it + 1) % cfg.VIS_PERIOD == 0 and is_main_process():
                            self._save_visualization(it + 1, batch, mutual=it >= burn_up)
                        self.storage.step()
                    nxt = it + 1
                    if nxt % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or nxt == self.max_iter:
                        with span("ubt.train.checkpoint"):
                            self.checkpointer.save(nxt, self.checkpoint_state())
                    if cfg.TEST.EVAL_PERIOD and nxt % cfg.TEST.EVAL_PERIOD == 0:
                        with span("ubt.train.eval"):
                            self._eval_and_log()
        finally:
            if profiler is not None:
                self._stop_profiler(profiler, profile_dir)
            data_iter.close()
            self.loader.close()
        self.checkpointer.wait_until_finished()
        self.storage.close()
        if cfg.TEST.EXPECTED_RESULTS:
            verify_results(cfg, self.test(model="teacher"))

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, profile_dir: str) -> None:
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_iter{self.start_iter + 10}.json")
        profiler.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)

    # -- visualization ------------------------------------------------------
    def _save_visualization(self, iteration: int, batch, mutual: bool) -> None:
        """Training visualization with reference parity
        (one_stage_detector.py:242-321): labeled = gt | student
        predictions; unlabeled (mutual phase) = teacher pseudo-cls |
        pseudo-reg | student predictions. First image of each stream."""
        from ..utils.visualizer import save_training_panels

        img_l = batch["images_label_k"][:1]
        hw_l = batch["label_hw"][:1].float()
        gt = batch["gt_label"].map(lambda x: x[0].cpu().numpy())
        image_l = img_l[0].cpu().numpy()
        panels = [{"title": "gt", "image": image_l, "boxes": gt.boxes, "mask": gt.mask, "classes": gt.classes}]
        panels.append(dict(self._vis_predictions(self.state.student, img_l, hw_l),
                           title="student pred", image=image_l))
        save_training_panels(self.cfg.OUTPUT_DIR, iteration, "labeled", panels)
        if not mutual:
            return
        img_u = batch["images_unlabel_k"][:1]
        hw_u = batch["unlabel_hw"][:1].float()
        image_u = img_u[0].cpu().numpy()
        upanels = [dict(p, title=title, image=image_u)
                   for title, p in self._vis_pseudo_sets(self.state.teacher, img_u, hw_u)]
        upanels.append(dict(self._vis_predictions(self.state.student, img_u, hw_u),
                            title="student pred", image=image_u))
        save_training_panels(self.cfg.OUTPUT_DIR, iteration, "unlabeled", upanels)

    @staticmethod
    def _panel(dets, keep=None) -> Dict[str, np.ndarray]:
        """The first image's detections as a panel dict."""
        return {
            "boxes": dets.boxes[0].cpu().numpy(),
            "mask": (dets.mask[0] if keep is None else keep).cpu().numpy(),
            "classes": dets.classes[0].cpu().numpy(),
            "scores": dets.scores[0].cpu().numpy(),
        }

    def _vis_predictions(self, model, images, hw) -> Dict[str, np.ndarray]:
        return self._panel(self._vis_infer_fn()(model, images.float(), hw))

    def _vis_pseudo_sets(self, teacher, images, hw):
        """-> [(title, panel)] of the teacher's thresholded pseudo boxes."""
        f = self.cfg.MODEL.FCOS
        out = []
        for title, method in (("pseudo-cls", f.NMS_CRITERIA_TRAIN), ("pseudo-reg", f.NMS_CRITERIA_REG_TRAIN)):
            dets = self._vis_infer_fn(method)(teacher, images.float(), hw)
            keep = dets.mask[0] & (dets.scores[0] > self.cfg.SEMISUPNET.BBOX_THRESHOLD)
            out.append((title, self._panel(dets, keep)))
        return out

    def _vis_infer_fn(self, method: str | None = None) -> Callable:
        """The FCOS decode at train-time thresholds, per NMS criterion."""
        from ..evaluation.evaluator import make_fcos_inference_fn

        key = method or self.cfg.MODEL.FCOS.NMS_CRITERIA_TRAIN
        if key not in self._vis_fns:
            self._vis_fns[key] = make_fcos_inference_fn(self.cfg, key, train=True)
        return self._vis_fns[key]

    # -- evaluation ---------------------------------------------------------
    def _eval_and_log(self) -> None:
        results = self.test(model="teacher")
        self.storage.put_scalars(**{f"teacher/{k}": v for k, v in results.items()})
        results_s = self.test(model="student")
        self.storage.put_scalars(**{f"student/{k}": v for k, v in results_s.items()})
        logger.info("eval teacher AP=%.2f student AP=%.2f",
                    results.get("AP", float("nan")), results_s.get("AP", float("nan")))

    def test(self, model: str = "teacher") -> Dict[str, float]:
        """COCO metrics of the teacher or the student on the test set. Each
        rank infers its contiguous share (np.array_split by rank, the
        reference's InferenceSampler) and every rank scores all of it."""
        module = self.state.teacher if model == "teacher" else self.state.student
        test_dicts = self.datasets["test"]
        shard = [test_dicts[i] for i in np.array_split(np.arange(len(test_dicts)), world_size())[rank()]]
        loader = TestDataLoader(self.cfg, shard, batch_size=self.cfg.TPU.EVAL_BATCH,
                                image_loader=self._image_loader)
        return inference_on_dataset(
            self.cfg, module, loader, test_dicts,
            nms_method=self.cfg.MODEL.FCOS.NMS_CRITERIA_TEST,
            num_classes=self._num_classes(),
            infer_fn=self._infer_fn(),
            proposal_fn=self._proposal_fn(),
        )

    # -- overridables (FCOS defaults) ---------------------------------------
    def _build_model(self, cfg, generator: torch.Generator):
        from ..modeling.fcos_head import build_one_stage_detector

        return build_one_stage_detector(cfg, self.device, generator)

    def _torch_converter(self) -> Callable:
        from ..checkpoint.torch_weights import convert_ubt_fcos_model

        depth = self.cfg.MODEL.RESNETS.DEPTH
        return lambda sd: convert_ubt_fcos_model(sd, depth)

    def _make_steps(self, cfg):
        return make_fcos_train_steps(cfg)

    def _infer_fn(self):
        return None  # the evaluator builds the FCOS one

    def _proposal_fn(self):
        return None  # box-proposal AR is an R-CNN (RPN) eval feature

    def _num_classes(self) -> int:
        return self.cfg.MODEL.FCOS.NUM_CLASSES


class UBRCNNTeacherTrainer(UBTeacherTrainer):
    """Faster R-CNN semi-supervised trainer
    (SEMISUPNET.Trainer == 'ubteacher_rcnn'; reference: trainer.py:612-1023).
    As in the reference, the NMS-criteria choice at eval is FCOS-only: R-CNN
    eval runs the stock inference."""

    def _build_model(self, cfg, generator: torch.Generator):
        from ..modeling.rcnn import build_two_stage_rcnn

        return build_two_stage_rcnn(cfg, self.device, generator)

    def _make_steps(self, cfg):
        from .rcnn_trainer import make_rcnn_train_steps

        return make_rcnn_train_steps(cfg)

    def _infer_fn(self):
        from .rcnn_trainer import make_rcnn_inference_fn

        return make_rcnn_inference_fn(self.cfg)

    def _proposal_fn(self):
        if not self.cfg.TEST.EVAL_PROPOSALS:
            return None
        from .rcnn_trainer import make_rcnn_proposal_fn

        return make_rcnn_proposal_fn(self.cfg)

    def _num_classes(self) -> int:
        return self.cfg.MODEL.ROI_HEADS.NUM_CLASSES

    def _torch_converter(self) -> Callable:
        from ..checkpoint.torch_weights import convert_ubt_rcnn_model

        depth = self.cfg.MODEL.RESNETS.DEPTH
        pooler = self.cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
        return lambda sd: convert_ubt_rcnn_model(sd, depth, pooler)

    def _vis_infer_fn(self, method: str | None = None) -> Callable:
        # the NMS-criteria variants are FCOS-only; R-CNN uses stock inference
        if "rcnn" not in self._vis_fns:
            self._vis_fns["rcnn"] = self._infer_fn()
        return self._vis_fns["rcnn"]

    def _vis_pseudo_sets(self, teacher, images, hw):
        """R-CNN pseudo labels are one score-thresholded set (reference:
        trainer.py:727-769)."""
        dets = self._vis_infer_fn()(teacher, images.float(), hw)
        keep = dets.mask[0] & (dets.scores[0] > self.cfg.SEMISUPNET.BBOX_THRESHOLD)
        return [("pseudo", self._panel(dets, keep))]
