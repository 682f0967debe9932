"""The R-CNN train cell: the port's `UBRCNNTeacherTrainer.train()` (mutual
phase) on the cell's traffic, timed from the harness's side as the FCOS
cell is (harness/train_cell.py: its window, recorder, loader proxy and
snapshots).

Set-up builds the R-CNN trainer, warms all 16 canvas pairs with one eager
mutual step each and puts back the seed's weights. While the first
`check_steps` iterations run, the harness records every discrete choice the
program derives by ranking or thresholding floats, through the port's own
returned indices (wrappers of the names `engine/rcnn_trainer.py` calls):
the RPN's top-k, NMS and global top-k at both settings
(`find_top_proposals(return_choices=True)`), the anchor matcher's labels,
the proposal matcher's labels (`sample_proposals`' match_idxs and
match_labels), the box head's inference ranking
(`fast_rcnn_inference(return_choices=True)`) and the BBOX_THRESHOLD mask.
The float32 reference then replays them where admissible
(harness/rcnn_refrun.py). A port without those returned indices cannot run
the cell: the build stops at once.

With --trace 1 the traced iterations also record the calls of the ROIAlign
forward (`modeling/rcnn.py`'s `multilevel_roi_align`) and of the anchor
matcher, whose bounds (harness/rcnn_bounds.py) the kernels' roofline
shares divide, and the run keeps the program's spans
(harness/program_trace.py), whose readings standard error prints beside
the compared numbers.

The control, the float32 reference against its float8 self, each seed's
line of JSON:

    python -m benchmark.harness.rcnn_train_cell --control --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
from typing import Dict, List

import torch

from . import cfgs, compare, manifest, program_trace, rcnn_bounds, rcnn_refrun, traffic as traffic_mod
from . import weights as weights_mod
from .train_cell import TrainCell

WORKLOAD = "rcnn_mutual_recipe"


def _compact(x: torch.Tensor) -> torch.Tensor:
    """A recorded index or label on the host, in the narrowest dtype that
    holds it (the anchor matcher's are (B, A) of ~340k anchors)."""
    if x.dtype == torch.bool or x.is_floating_point():
        return x.detach().cpu()
    hi = int(x.abs().max()) if x.numel() else 0
    dtype = torch.int8 if hi < 2**7 else torch.int16 if hi < 2**15 else torch.int32
    return x.detach().to(dtype).cpu()


class Recording:
    """Stands in for the port's choice functions (the names
    `engine/rcnn_trainer.py` calls) and for `modeling/rcnn.py`'s
    `multilevel_roi_align` while in use (`with recording:`). `phase()` ->
    (the step whose choices to record or None, whether to record the ROI
    kernels' calls). `choices[i][kind]` lists step i's records in call
    order, in the layout the reference replays (reference/ubtref/engine/
    replay.py); `calls` the ROIAlign and matcher calls (harness/rcnn_bounds.py)."""

    NAMES = ("find_top_proposals", "match_anchors_batched", "sample_proposals", "fast_rcnn_inference",
             "threshold_pseudo_labels")

    def __init__(self, phase):
        self.phase = phase
        self.choices: List[Dict[str, list]] = []
        self.calls: Dict[str, list] = {"roi_align": [], "match": []}
        self._saved = {}

    def record(self, kind: str, **tensors):
        step, _ = self.phase()
        if step is None:
            return
        while len(self.choices) <= step:
            self.choices.append({})
        self.choices[step].setdefault(kind, []).append({k: _compact(v) for k, v in tensors.items()})

    def _wrappers(self):
        from ubteacher_tpu_torch.engine import rcnn_trainer as rt
        from ubteacher_tpu_torch.modeling import rcnn

        orig = {n: getattr(rt, n) for n in self.NAMES}
        roi_align = rcnn.multilevel_roi_align

        def find_top_proposals(*args, **kwargs):
            if self.phase()[0] is None:
                return orig["find_top_proposals"](*args, **kwargs)
            *out, chosen = orig["find_top_proposals"](*args, return_choices=True, **kwargs)
            self.record("rpn", **chosen)
            return tuple(out)

        def match_anchors_batched(anchors, gt_boxes, gt_mask, *args, **kwargs):
            idx, labels = orig["match_anchors_batched"](anchors, gt_boxes, gt_mask, *args, **kwargs)
            self.record("anchor_match", idx=idx, labels=labels, gt_mask=gt_mask)
            if self.phase()[1]:
                self.calls["match"].append({"anchor_boxes": anchors, "gt_boxes": gt_boxes.detach().clone(),
                                            "gt_mask": gt_mask.clone(),
                                            "out_bytes": idx.element_size() + labels.element_size()})
            return idx, labels

        def sample_proposals(prop_boxes, prop_mask, gt, *args, **kwargs):
            out = orig["sample_proposals"](prop_boxes, prop_mask, gt, *args, **kwargs)
            self.record("proposal_match", idx=out["match_idxs"], labels=out["match_labels"], gt_mask=gt.mask)
            return out

        def fast_rcnn_inference(*args, **kwargs):
            if self.phase()[0] is None:
                return orig["fast_rcnn_inference"](*args, **kwargs)
            dets, chosen = orig["fast_rcnn_inference"](*args, return_choices=True, **kwargs)
            self.record("box_inference", **chosen)
            return dets

        def threshold_pseudo_labels(*args, **kwargs):
            out = orig["threshold_pseudo_labels"](*args, **kwargs)
            self.record("pseudo", keep=out.mask)
            return out

        def multilevel_roi_align(feats, boxes, *args, **kwargs):
            if self.phase()[1]:
                self.calls["roi_align"].append({
                    "boxes": boxes.detach().float().clone(), "shapes": [tuple(f.shape) for f in feats],
                    "dtype_bytes": feats[0].element_size(), "args": args, "kwargs": kwargs,
                    "backward": torch.is_grad_enabled() and any(f.requires_grad for f in feats)})
            return roi_align(feats, boxes, *args, **kwargs)

        local = locals()
        out = {(rt, n): local[n] for n in self.NAMES}
        out[(rcnn, "multilevel_roi_align")] = multilevel_roi_align
        return out

    def __enter__(self):
        wrappers = self._wrappers()
        self._saved = {key: getattr(*key) for key in wrappers}
        for (mod, name), fn in wrappers.items():
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self._saved.items():
            setattr(mod, name, fn)
        self._saved = {}


class RCNNTrainCell(TrainCell):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.choices: List[Dict[str, list]] = []
        self.replay: Dict[str, int] = {}
        self.spans: Dict = {}

    # -- set-up -------------------------------------------------------------
    def build(self):
        from ubteacher_tpu_torch import config as port_config
        from ubteacher_tpu_torch.engine.trainer import UBRCNNTeacherTrainer
        from ubteacher_tpu_torch.modeling import fast_rcnn, rpn

        for fn in (rpn.find_top_proposals, fast_rcnn.fast_rcnn_inference):
            if "return_choices" not in inspect.signature(fn).parameters:
                raise SystemExit(f"{self.workload['name']}: this port's {fn.__name__} does not return its choices")
        out_dir = os.path.join(manifest.BENCH_DIR, "_out", self.workload["name"])
        self.cfg = cfgs.build(port_config, self.conf["cfg"], dict(self.cfg_extra, OUTPUT_DIR=out_dir))
        self.pool, self.dicts = traffic_mod.make_pool(self.mix, self.seed, threads=self.cfg.TPU.DATA_THREADS)
        datasets = {"train": self.dicts["label"], "train_unlabel": self.dicts["unlabel"], "test": [], "meta": {}}
        self.trainer = UBRCNNTeacherTrainer(self.cfg, datasets=datasets, image_loader=self.pool, device=self.device)
        state = self.trainer.state
        self.w0 = weights_mod.make_weights(weights_mod.param_shapes(state.student), self.conf["init"],
                                           self.seed, self.device)
        self.names = {id(p): n for n, p in state.student.named_parameters()}
        self.warm_up()
        self._reset_state()

    def _phase(self):
        """(the check step under way or None, whether the profiler records),
        from the trainer's wrapped storage (train_cell's Recorder) while
        `train()` runs."""
        rec = self.trainer.storage
        i = len(rec.ends)
        return (i if i < self.check_steps else None), rec.profiler is not None

    # -- the run -------------------------------------------------------------
    def run(self) -> Dict:
        with Recording(self._phase) as recording:
            run = super().run()
        self.choices = recording.choices
        sup = 2 if self.cfg.SEMISUPNET.USE_SUP_STRONG == "both" else 1
        run["student_images_per_iteration"] = (sup * self.cfg.SOLVER.IMG_PER_BATCH_LABEL
                                               + self.cfg.SOLVER.IMG_PER_BATCH_UNLABEL)
        if self.profile is not None:
            run["program_trace"] = self.spans = program_trace.reduce_profile(self.profile)
            run["trace_steps"] = self.trace_steps
            if self.device.type == "cuda":
                from .peaks import peaks

                run["kernel_bounds"] = rcnn_bounds.bounds_s(recording.calls, peaks(torch.cuda.get_device_name(0)))
        return run

    # -- correctness ---------------------------------------------------------
    def reference_run(self, lower_precision: bool = False, program=None):
        """(readings, Choices) of the float32 reference (float8 products with
        lower_precision) replaying `program`'s choices."""
        return rcnn_refrun.reference_steps(self.conf, self.cfg_extra, self.seed, self.pool, self.dicts,
                                           self.check_steps, self.device, lower_precision, program)

    def compare(self, lower_precision: bool = False) -> Dict[str, float]:
        """The compared numbers: the program's first steps (with
        lower_precision, the control's: the reference computed with float8
        products, choosing alone) against the float32 reference replaying
        their choices."""
        if lower_precision:
            prog, chosen = self.reference_run(True)
            prog_choices = chosen.chosen
        else:
            prog, prog_choices = self.program_readings, self.choices
        ref, replayed = self.reference_run(False, prog_choices)
        self.replay = replayed.counts()
        self.details = dict(self.host, **program_trace.details(self.spans), **compare.step_gaps(prog, ref),
                            **self.replay)
        return compare.readings(prog, ref)

    def prepare(self):
        """The JPEG pool and dicts alone (the control runs no program)."""
        threads = int(dict(self.conf["cfg"], **self.cfg_extra).get("TPU.DATA_THREADS", 8))
        self.pool, self.dicts = traffic_mod.make_pool(self.mix, self.seed, threads=threads)


Cell = RCNNTrainCell


def control(seed: int, device, cfg_extra=None, mix_extra=None) -> Dict:
    """The control's compared numbers and the replay's counts on one seed."""
    cell = RCNNTrainCell(manifest.workload(manifest.manifest(), WORKLOAD), seed, 0.0, False, device, cfg_extra,
                         mix_extra)
    cell.prepare()
    numbers = cell.compare(lower_precision=True)
    return dict(numbers, **cell.replay)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the float8 control of the R-CNN cell, seed by seed")
    ap.add_argument("--control", action="store_true", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the control runs on the card")
    torch.set_num_threads(1)
    for seed in args.seeds:
        numbers = control(seed, torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "control": {k: v if isinstance(v, (int, str)) or math.isfinite(v) else str(v)
                                                     for k, v in numbers.items()}}), flush=True)


if __name__ == "__main__":
    main()
