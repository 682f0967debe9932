"""FCOS semi-supervised train steps (PyTorch port of
ubteacher_tpu.engine.fcos_trainer; reference ubteacher/engine/trainer.py:
181-429).

`burnin_step` is the supervised-only step; `mutual_step` updates the EMA
teacher, runs the teacher on the weak unlabeled images, decodes two pseudo
sets (NMS_CRITERIA_TRAIN for cls, NMS_CRITERIA_REG_TRAIN for reg), applies
the strong augmentation, runs ONE student forward over labeled strong+weak and
unlabeled strong (batch 3B when the canvases match), assigns targets and takes
an SGD step on the w/(w+1)-weighted losses. Burn-in vs mutual selection stays
with the caller, on `state.step`.

Both steps update `state` in place (student and teacher parameters, the
optimizer) where the JAX steps donate it, and return (state, metrics) with
the metrics as device tensors (no host sync inside a step).

Each phase runs in a span (utils/events.py): ubt.step.ema, .teacher_forward,
.pseudo_labels, .strong_aug, .student_forward, .losses, and sgd_step's
.backward, .grad_allreduce and .optimizer.

On the card the model runs under bf16 autocast when TPU.COMPUTE_DTYPE is
"bfloat16"; head outputs, losses and the optimizer stay in float32.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from ..modeling.fcos_outputs import (
    compute_locations,
    fcos_assign_targets,
    fcos_decode,
    fcos_loss_config,
    fcos_pseudo_losses,
    fcos_supervised_losses,
    level_feature_sizes,
    threshold_pseudo_labels,
    threshold_pseudo_labels_cls_ctr,
)
from ..solver.build import Optimizer
from ..structures import PaddedInstances
from ..utils.events import span
from .common import float_images, hw_or_canvas, sgd_step, strong_view


@dataclasses.dataclass
class FCOSTrainState:
    step: int
    student: nn.Module
    teacher: nn.Module
    optimizer: Optimizer

    @staticmethod
    def create(model: nn.Module, optimizer: Optimizer) -> "FCOSTrainState":
        """The teacher starts as a copy of the student and never trains."""
        teacher = copy.deepcopy(model).requires_grad_(False)
        return FCOSTrainState(step=0, student=model, teacher=teacher, optimizer=optimizer)


@torch.no_grad()
def _ema_update(teacher: nn.Module, student: nn.Module, keep_rate: float) -> None:
    """teacher <- student * (1 - keep) + teacher * keep, in place, in float32
    arithmetic as the JAX package computes it (reference trainer.py:477-482)."""
    if keep_rate == 1.0:
        return
    keep = torch.tensor(keep_rate, dtype=torch.float32)
    t_params = list(teacher.parameters())
    s_params = list(student.parameters())
    s_part = torch._foreach_mul(s_params, float(1.0 - keep))
    torch._foreach_mul_(t_params, float(keep))
    torch._foreach_add_(t_params, s_part)


def make_fcos_train_steps(cfg) -> Tuple[Callable, Callable]:
    """Returns (burnin_step, mutual_step).

    batch layout:
      images_label_k   : (B, H, W, 3) weak-augmented labeled, BGR [0, 255]
      gt_label         : PaddedInstances (B, MAX_GT, ...)
      images_unlabel_k : (Bu, Hu, Wu, 3) weak-augmented unlabeled
      rng              : torch.Generator on the images' device, for the
                         strong-augmentation draws (the same seeded
                         generator on every rank)
      label_hw, unlabel_hw (optional): (B, 2) true image sizes
      gt_unlabel (TPU.ORACLE_PSEUDO only): PaddedInstances
      strong_label, strong_unlabel (optional): StrongAugParams to apply in
                         place of draws from `rng`

    Under data parallelism (parallel/dist.py) the batch holds this rank's
    rows; draws are for the global batch and each rank applies its own rows
    of them, losses are this rank's shares of the global ones and the
    gradients are summed over the ranks before the update.
    """
    # float32 math stays float32 on the card: the convolutions run in bf16
    # under autocast (TPU.COMPUTE_DTYPE), and nothing else drops to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    fcfg = fcos_loss_config(cfg)
    strides = list(cfg.MODEL.FCOS.FPN_STRIDES)
    sem = cfg.SEMISUPNET
    f = cfg.MODEL.FCOS
    burn_up = sem.BURN_UP_STEP
    ema_keep = sem.EMA_KEEP_RATE
    update_iter = sem.TEACHER_UPDATE_ITER
    w_unsup = sem.UNSUP_LOSS_WEIGHT
    w_reg_unsup = sem.UNSUP_REG_LOSS_WEIGHT
    max_pseudo = cfg.TPU.MAX_PSEUDO
    bf16 = cfg.TPU.COMPUTE_DTYPE == "bfloat16"

    def _forward(model: nn.Module, images: torch.Tensor, hw: torch.Tensor):
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=bf16):
            return model(images, hw)

    def _sup_losses_from_dense(dense, hw, gt, image_hw):
        grid = compute_locations(hw, strides, image_hw.device)
        targets = fcos_assign_targets(
            grid, gt, fcfg["num_classes"], fcfg["center_sample"],
            fcfg["pos_radius"], image_hw=image_hw,
        )
        return fcos_supervised_losses(dense, targets, fcfg)

    def burnin_step(state: FCOSTrainState, batch: Dict[str, Any]):
        """Supervised-only step on labeled strong+weak (reference
        trainer.py:191-210)."""
        batch = float_images(batch)
        images_l = batch["images_label_k"]
        label_hw = hw_or_canvas(batch, "label_hw", images_l)
        with span("ubt.step.strong_aug"):
            label_q = strong_view(batch, "label", images_l)
        images = torch.cat([label_q, images_l], 0)
        gt2 = batch["gt_label"].map(lambda x: torch.cat([x, x], 0))
        hw2 = torch.cat([label_hw, label_hw], 0)
        with span("ubt.step.student_forward"):
            dense = _forward(state.student, images, hw2)
        with span("ubt.step.losses"):
            losses = _sup_losses_from_dense(dense, images.shape[1:3], gt2, hw2)
            total = sum(losses.values())
        sgd_step(state, total)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return state, metrics

    def _decode_teacher(dense_t, images, nms_method, hw):
        h, w = images.shape[1:3]
        grid = compute_locations((h, w), strides, images.device)
        lengths = [fh * fw for fh, fw in level_feature_sizes((h, w), strides)]
        return fcos_decode(
            dense_t, grid, lengths, hw, fcfg,
            nms_method=nms_method,
            pre_nms_thresh=f.INFERENCE_TH_TRAIN,
            pre_nms_topk=f.PRE_NMS_TOPK_TRAIN,
            post_nms_topk=f.POST_NMS_TOPK_TRAIN,
            nms_thresh=f.NMS_TH,
            total_candidates=cfg.TPU.NMS_CANDIDATES,
        )

    def _threshold(dets, sample: str, thresh: float, ctr_thresh: float) -> PaddedInstances:
        if sample == "thresholding":
            return threshold_pseudo_labels(dets, thresh, max_pseudo)
        if sample == "thresholding_cls_ctr":
            return threshold_pseudo_labels_cls_ctr(dets, thresh, ctr_thresh, max_pseudo)
        raise ValueError(sample)

    @torch.no_grad()
    def _teacher_pseudo_sets(teacher, unl_k, unlabel_hw):
        """Teacher forward + BOTH NMS passes + PSEUDO_BBOX_SAMPLE dispatch
        (reference trainer.py:231-294) -> (pseudo_cls, pseudo_reg, number of
        valid NMS candidates over both passes)."""
        with span("ubt.step.teacher_forward"):
            dense_t = _forward(teacher, unl_k, unlabel_hw)
        with span("ubt.step.pseudo_labels"):
            det_cls = _decode_teacher(dense_t, unl_k, f.NMS_CRITERIA_TRAIN, unlabel_hw)
            det_reg = _decode_teacher(dense_t, unl_k, f.NMS_CRITERIA_REG_TRAIN, unlabel_hw)
            pseudo_cls = _threshold(det_cls, sem.PSEUDO_BBOX_SAMPLE,
                                    sem.BBOX_THRESHOLD, sem.BBOX_CTR_THRESHOLD)
            pseudo_reg = _threshold(det_reg, sem.PSEUDO_BBOX_SAMPLE_REG,
                                    sem.BBOX_THRESHOLD_REG, sem.BBOX_CTR_THRESHOLD_REG)
            n_cand = det_cls.num_candidates.sum() + det_reg.num_candidates.sum()
        return pseudo_cls, pseudo_reg, n_cand

    def mutual_step(state: FCOSTrainState, batch: Dict[str, Any]):
        """Mutual-learning step (reference trainer.py:212-429)."""
        batch = float_images(batch)
        # EMA cadence (reference trainer.py:213-222): copy at the burn-in
        # boundary (keep 0), EMA every TEACHER_UPDATE_ITER, else hold
        if state.step == burn_up:
            keep_rate = 0.0
        elif (state.step - burn_up) % update_iter == 0:
            keep_rate = ema_keep
        else:
            keep_rate = 1.0
        with span("ubt.step.ema"):
            _ema_update(state.teacher, state.student, keep_rate)

        images_l = batch["images_label_k"]
        unl_k = batch["images_unlabel_k"]
        unlabel_hw = hw_or_canvas(batch, "unlabel_hw", unl_k)
        label_hw = hw_or_canvas(batch, "label_hw", images_l)
        if cfg.TPU.ORACLE_PSEUDO:
            # positive control: both pseudo sets = the unlabeled stream's gt
            pseudo_cls = pseudo_reg = batch["gt_unlabel"]
            n_cand = torch.zeros((), dtype=torch.long, device=unl_k.device)
        else:
            pseudo_cls, pseudo_reg, n_cand = _teacher_pseudo_sets(
                state.teacher, unl_k, unlabel_hw
            )

        with span("ubt.step.strong_aug"):
            label_q = strong_view(batch, "label", images_l)
            unl_q = strong_view(batch, "unlabel", unl_k)

        images_all_l = torch.cat([label_q, images_l], 0)
        gt2 = batch["gt_label"].map(lambda x: torch.cat([x, x], 0))
        hw_l = torch.cat([label_hw, label_hw], 0)
        with span("ubt.step.student_forward"):
            if unl_q.shape[1:3] == images_all_l.shape[1:3]:
                # one student forward over labeled strong+weak AND unlabeled
                # strong: each conv runs once at batch 3B instead of 2B + B
                dense_all = _forward(
                    state.student,
                    torch.cat([images_all_l, unl_q], 0),
                    torch.cat([hw_l, unlabel_hw], 0),
                )
                dense_l, dense_u = dense_all.split(images_all_l.shape[0])
            else:  # mixed aspect buckets
                dense_l = _forward(state.student, images_all_l, hw_l)
                dense_u = _forward(state.student, unl_q, unlabel_hw)
        with span("ubt.step.losses"):
            sup = _sup_losses_from_dense(dense_l, images_all_l.shape[1:3], gt2, hw_l)

            grid_u = compute_locations(unl_q.shape[1:3], strides, unl_q.device)
            cls_targets = fcos_assign_targets(
                grid_u, pseudo_cls, fcfg["num_classes"], fcfg["center_sample"],
                fcfg["pos_radius"], ignore_near=sem.PSEUDO_CLS_IGNORE_NEAR,
                image_hw=unlabel_hw,
            )
            reg_targets = fcos_assign_targets(
                grid_u, pseudo_reg, fcfg["num_classes"], fcfg["center_sample"],
                fcfg["pos_radius"], image_hw=unlabel_hw,
            )
            unsup = fcos_pseudo_losses(
                dense_u, cls_targets, reg_targets, fcfg,
                ts_better=sem.TS_BETTER, ts_better_cert=sem.TS_BETTER_CERT,
                consist_reg_loss=sem.CONSIST_REG_LOSS,
            )
            tbs = unsup.pop("teacher_better_student")

            # w/(w+1) weighting scheme (reference trainer.py:378-410)
            weighted = {
                "loss_fcos_cls": sup["loss_fcos_cls"] / (w_unsup + 1.0),
                "loss_fcos_ctr": sup["loss_fcos_ctr"] / (w_unsup + 1.0),
                "loss_fcos_loc": sup["loss_fcos_loc"] / (w_reg_unsup + 1.0),
                "loss_fcos_cls_pseudo": unsup["loss_fcos_cls"] * w_unsup / (w_unsup + 1.0),
                "loss_fcos_ctr_pseudo": unsup["loss_fcos_ctr"] * w_unsup / (w_unsup + 1.0),
                "loss_fcos_loc_pseudo": unsup["loss_fcos_loc"] * w_reg_unsup / (w_reg_unsup + 1.0),
            }
            total = sum(weighted.values())
        sgd_step(state, total)

        metrics = {k: v.detach() for k, v in sup.items()}
        metrics.update({k + "_pseudo": v.detach() for k, v in unsup.items()})
        metrics["teacher_better_student"] = tbs.detach()
        metrics["total_loss"] = total.detach()
        metrics["ema_rate_1000x"] = torch.tensor(keep_rate, dtype=torch.float32) * 1000.0
        metrics["num_pseudo_cls"] = pseudo_cls.mask.sum()
        metrics["num_pseudo_reg"] = pseudo_reg.mask.sum()
        metrics["num_nms_candidates"] = n_cand
        return state, metrics

    return burnin_step, mutual_step
