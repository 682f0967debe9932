"""Faster R-CNN semi-supervised train steps: a frozen copy of the port's
(reference ubteacher/engine/trainer.py:612-1023 and meta_arch/rcnn.py:7-72),
in float32 with plain PyTorch in place of every kernel.

  * teacher (unsup_data_weak): RPN proposals at test settings -> box head ->
    fast_rcnn_inference with the boundary std attached -> score >
    BBOX_THRESHOLD pseudo labels;
  * student (supervised / unsup_data_train): RPN losses (objectness
    confidence-weighted on the pseudo rows), 512-proposal sampling, focal CE
    + nlloss / tsbetter box regression;
  * loss weights: rpn_loc_pseudo x 0, box_reg_pseudo x UNSUP_REG_LOSS_WEIGHT,
    the other pseudo losses x UNSUP_LOSS_WEIGHT, supervised x 1;
  * the EMA teacher update with the FCOS step's cadence.

Every discrete choice the steps derive by ranking or thresholding floats
(the RPN's proposals at both settings, the anchor and proposal matchers,
the box head's inference ranking, the BBOX_THRESHOLD pseudo labels) goes
through `choices` (engine/replay.py) when the steps are built with one: it
takes a compared run's choice where admissible and records what was taken.
Each step starts a step of `choices`.

Randomness: the strong augmentation and the two samplers (RPN anchors, ROI
proposals) draw from batch["rng"] in the port's order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..modeling.anchors import generate_anchors
from ..modeling.box_regression import Box2BoxTransform, Box2BoxXYXYTransform
from ..modeling.fast_rcnn import (
    box_reg_loss_nll,
    box_reg_loss_smooth_l1,
    box_reg_pseudo_loss_tsbetter,
    cross_entropy_loss,
    fast_rcnn_inference,
    focal_ce_loss,
    sample_proposals,
)
from ..modeling.fcos_outputs import threshold_pseudo_labels
from ..modeling.matcher import match_anchors_batched
from ..modeling.rpn import anchor_validity, find_top_proposals, label_anchors, rpn_losses
from ..structures import Detections, PaddedInstances
from .common import float_images, global_blocks, hw_or_canvas, owned_draws, sgd_step, strong_view
from .fcos_trainer import FCOSTrainState, _ema_update
from .replay import Choices, match_ok, threshold_ok

RCNNTrainState = FCOSTrainState  # the same state and EMA cadence


@dataclasses.dataclass
class SamplingDraws:
    """Uniform [0, 1) draws of one branch's two samplers: rpn (B, 2, A) for
    the positive and negative anchor samplers, roi (B, 2, P + M) for the
    positive and negative proposal samplers (P proposals, M gt slots)."""

    rpn: torch.Tensor
    roi: torch.Tensor


def _pad_slots(x: torch.Tensor, m: int) -> torch.Tensor:
    """Zero-pad the instance axis (1) to m slots."""
    if x.shape[1] == m:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], m - x.shape[1]) + x.shape[2:])], 1)


def _cat_instances(a: PaddedInstances, b: PaddedInstances) -> PaddedInstances:
    """Rows of a then b, both padded to the larger slot count (MAX_GT and
    MAX_PSEUDO may differ)."""
    m = max(a.boxes.shape[1], b.boxes.shape[1])
    return PaddedInstances(*(
        torch.cat([_pad_slots(getattr(a, f.name), m), _pad_slots(getattr(b, f.name), m)], 0)
        for f in dataclasses.fields(PaddedInstances)
    ))


class _RCNNParts:
    """The configuration-bound pieces shared by the train steps and the
    inference function."""

    def __init__(self, cfg, choices: Optional["Choices"] = None):
        self.cfg = cfg
        self.choices = choices
        self.rpn_cfg = cfg.MODEL.RPN
        self.roi_cfg = cfg.MODEL.ROI_HEADS
        self.strides = [2 ** int(f[1:]) for f in self.rpn_cfg.IN_FEATURES]
        self.rpn_box2box = Box2BoxTransform(tuple(self.rpn_cfg.BBOX_REG_WEIGHTS))
        self.roi_box2box = Box2BoxXYXYTransform(tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))
        self.bf16 = cfg.TPU.COMPUTE_DTYPE == "bfloat16"

    def autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=self.bf16)

    def anchors(self, canvas_hw, device):
        a = self.cfg.MODEL.ANCHOR_GENERATOR
        return generate_anchors(canvas_hw, self.strides, a.SIZES, a.ASPECT_RATIOS, a.OFFSET, device)

    def rpn(self, model, images, hw):
        """features -> RPN outputs and the canvas's anchors."""
        with self.autocast(images.device):
            pyramid = model.features(images, hw)
            logits, deltas = model.rpn(pyramid)
        return pyramid, logits, deltas, self.anchors(images.shape[1:3], images.device)

    def top_proposals(self, anch, logits, deltas, hw, train: bool):
        """(boxes, objectness, mask, the sampler's draw slots or None) of the
        RPN's proposals at train or test settings (carrying no gradient,
        reference fast_rcnn.py:856-858)."""
        r = self.rpn_cfg
        return find_top_proposals(
            anch["anchors"], anch["level_lengths"], logits.detach(), deltas.detach(), hw,
            self.rpn_box2box,
            r.PRE_NMS_TOPK_TRAIN if train else r.PRE_NMS_TOPK_TEST,
            r.POST_NMS_TOPK_TRAIN if train else r.POST_NMS_TOPK_TEST,
            r.NMS_THRESH,
            total_candidates=self.cfg.TPU.NMS_CANDIDATES,
            cell_origins=anch["cell_origins"],
            min_size=self.cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE,
            choices=self.choices,
        )

    def proposals(self, model, images, hw, train: bool):
        """features -> RPN -> proposals (and their draw slots or None)."""
        pyramid, logits, deltas, anch = self.rpn(model, images, hw)
        boxes, _, mask, slots = self.top_proposals(anch, logits, deltas, hw, train)
        return pyramid, logits, deltas, anch, boxes, mask, slots

    def roi_box(self, model, pyramid, boxes):
        with self.autocast(boxes.device):
            return model.roi_box(pyramid, boxes)

    @torch.no_grad()
    def detect(self, model, images, hw) -> Detections:
        """Test-time detections: proposals at test settings, the box head,
        fast_rcnn_inference."""
        return self.inference(self.box_outputs(model, images, hw), hw)

    @torch.no_grad()
    def box_outputs(self, model, images, hw):
        """Proposals at test settings, the box head's outputs on them and
        the proposals' slots (find_top_proposals)."""
        pyramid, _, _, _, boxes, mask, slots = self.proposals(model, images, hw, train=False)
        return (boxes, mask) + tuple(self.roi_box(model, pyramid, boxes)) + (slots,)

    def inference(self, outputs, hw) -> Detections:
        """box_outputs -> fast_rcnn_inference's detections."""
        roi = self.roi_cfg
        return fast_rcnn_inference(
            *outputs[:-1], hw, self.roi_box2box,
            roi.SCORE_THRESH_TEST, roi.NMS_THRESH_TEST, self.cfg.TEST.DETECTIONS_PER_IMAGE,
            total_candidates=self.cfg.TPU.NMS_CANDIDATES, choices=self.choices,
            proposal_slots=None if outputs[-1] is None else outputs[-1].at,
        )


def make_rcnn_train_steps(cfg, choices: Optional["Choices"] = None) -> Tuple[Callable, Callable]:
    """Returns (burnin_step, mutual_step); with `choices`, their discrete
    choices go through it (engine/replay.py).

    batch layout:
      images_label_k   : (B, H, W, 3) weak-augmented labeled, BGR [0, 255]
      gt_label         : PaddedInstances (B, MAX_GT, ...)
      images_unlabel_k : (Bu, Hu, Wu, 3) weak-augmented unlabeled
      rng              : torch.Generator on the images' device
      label_hw, unlabel_hw (optional): (B, 2) true image sizes
      gt_unlabel (TPU.ORACLE_PSEUDO only): PaddedInstances
      strong_label, strong_unlabel (optional): StrongAugParams
      sampling_sup, sampling_unsup (optional): SamplingDraws of the
                         supervised branch (in the fused mutual step: of the
                         whole 3B batch) and of the pseudo branch (mixed
                         canvases only)
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    parts = _RCNNParts(cfg, choices)
    sem = cfg.SEMISUPNET
    rpn_cfg, roi_cfg = parts.rpn_cfg, parts.roi_cfg
    box_cfg = cfg.MODEL.ROI_BOX_HEAD
    num_classes = roi_cfg.NUM_CLASSES
    burn_up = sem.BURN_UP_STEP
    sup_strong = sem.USE_SUP_STRONG == "both"
    pseudo_reg_type = box_cfg.BBOX_PSEUDO_REG_LOSS_TYPE

    def _sampling(batch, key, blocks, num_anchors, num_props, device) -> SamplingDraws:
        """This rank's rows of the samplers' draws for the global batch,
        whose blocks (the streams in the student batch) have `blocks` local
        rows each."""
        blocks = global_blocks(blocks)
        draws = batch.get(f"sampling_{key}")
        if draws is None:
            gen = batch["rng"]
            b = sum(blocks)
            draws = SamplingDraws(
                torch.rand((b, 2, num_anchors), generator=gen, device=device),
                torch.rand((b, 2, num_props), generator=gen, device=device),
            )
        return owned_draws(draws, blocks)

    def _pseudo_box_reg(boxes, gt_boxes, bdeltas, bstd, gt_loc_std, is_fg, valid):
        """BBOX_PSEUDO_REG_LOSS_TYPE dispatch (reference fast_rcnn.py:534-566)."""
        if pseudo_reg_type == "tsbetter":
            return box_reg_pseudo_loss_tsbetter(boxes, gt_boxes, bdeltas, bstd, gt_loc_std, is_fg, valid,
                                                parts.roi_box2box, sem.TS_BETTER, sem.T_CERT)
        if pseudo_reg_type == "smooth_l1":
            return box_reg_loss_smooth_l1(boxes, gt_boxes, bdeltas, is_fg, valid, parts.roi_box2box,
                                          box_cfg.SMOOTH_L1_BETA)
        raise ValueError(f"Invalid bbox pseudo reg loss type '{pseudo_reg_type}'")

    def _anchor_match(anchors, gt):
        """The RPN matcher, the compared run's labels where admissible
        ("anchor_match", per image)."""
        matched = match_anchors_batched(anchors, gt.boxes, gt.mask)
        if choices is None:
            return matched
        program = choices.program_record("anchor_match", anchors.device)
        if program is not None:
            # match_anchors_batched's thresholds and labels
            ok = match_ok(gt.boxes, gt.mask, anchors, program["idx"], program["labels"], (0.3, 0.7), (0, -1, 1),
                          True, choices.delta) & (program["gt_mask"] == gt.mask).all(1)
            ok = choices.take("anchor_match", ok)
            matched = (choices.pick(ok, program["idx"].long(), matched[0]),
                       choices.pick(ok, program["labels"].long(), matched[1]))
        choices.record("anchor_match", idx=matched[0], labels=matched[1], gt_mask=gt.mask)
        return matched

    def _pseudo_labels(dets):
        """BBOX_THRESHOLD's pseudo labels, the compared run's mask where
        admissible ("pseudo", per image)."""
        pseudo = threshold_pseudo_labels(dets, sem.BBOX_THRESHOLD, cfg.TPU.MAX_PSEUDO)
        if choices is None:
            return pseudo
        program = choices.program_record("pseudo", pseudo.mask.device)
        if program is not None:
            eligible = threshold_pseudo_labels(dets, float("-inf"), cfg.TPU.MAX_PSEUDO).mask
            ok = threshold_ok(pseudo.scores, eligible, program["keep"], sem.BBOX_THRESHOLD, choices.eps)
            pseudo = dataclasses.replace(pseudo, mask=choices.merge("pseudo", ok, program["keep"], pseudo.mask))
        choices.record("pseudo", keep=pseudo.mask)
        return pseudo

    def _start():
        if choices is not None:
            choices.start_step()

    def _branches(model, images, gt, hw, batch, key, blocks, nl):
        """RPN + ROI losses over one forward of `images`, the streams of
        `blocks` rows each in order, whose first nl rows are supervised and
        the rest pseudo-labeled (reference rcnn.py:23-68). Every loss
        normalises by its own rows' counts, so the two row slices give what
        two separate branches give. Returns (sup, unsup, counts); a branch
        with no rows is None."""
        b = images.shape[0]
        dev = images.device
        pyramid, logits, deltas, anch, pboxes, pmask, slots = parts.proposals(model, images, hw, train=True)
        n_props = pboxes.shape[1] + (gt.boxes.shape[1] if roi_cfg.PROPOSAL_APPEND_GT else 0)
        draws = _sampling(batch, key, blocks, anch["anchors"].shape[0], n_props, dev)
        matched = _anchor_match(anch["anchors"], gt)
        # labeled rows are not confidence-weighted (a no-gt labeled image
        # keeps its all-background BCE); pseudo rows are weighted by
        # teacher score
        labeled = label_anchors(
            gt, rpn_cfg.BATCH_SIZE_PER_IMAGE, rpn_cfg.POSITIVE_FRACTION, draws.rpn,
            torch.arange(b, device=dev) >= nl, anchor_validity(anch["cell_origins"], hw), matched,
        )
        sampled = sample_proposals(
            pboxes, pmask, gt, roi_cfg.BATCH_SIZE_PER_IMAGE, roi_cfg.POSITIVE_FRACTION,
            num_classes, draws.roi, append_gt=roi_cfg.PROPOSAL_APPEND_GT, choices=choices,
            draw_slots=None if slots is None else slots.draws,
        )
        scores, bdeltas, bstd = parts.roi_box(model, pyramid, sampled["boxes"])
        counts = {
            "num_proposals": pmask.sum(),
            "num_rpn_samples": labeled["ok"].sum(),
            "num_roi_samples": sampled["valid"].sum(),
            "num_roi_fg": sampled["is_fg"].sum(),
        }

        out = []
        for sl, pseudo in ((slice(0, nl), False), (slice(nl, b), True)):
            if sl.start == sl.stop:
                out.append(None)
                continue

            def flat(x):
                y = x[sl]
                return y.reshape(-1, *y.shape[2:])

            losses = rpn_losses(
                anch["anchors"], logits[sl], deltas[sl], {k: v[sl] for k, v in labeled.items()},
                parts.rpn_box2box, rpn_cfg.BATCH_SIZE_PER_IMAGE, rpn_cfg.SMOOTH_L1_BETA,
            )
            cls_args = (flat(scores), flat(sampled["gt_classes"]), flat(sampled["valid"]))
            if roi_cfg.LOSS.startswith("FocalLoss"):
                # only the plain FocalLoss weights the pseudo cls loss by
                # the teacher's confidence (reference fast_rcnn.py:1368-1371,
                # 1398)
                confid = flat(sampled["gt_confid"]) if pseudo and roi_cfg.LOSS == "FocalLoss" else None
                losses["loss_cls"] = focal_ce_loss(*cls_args, confid=confid)
            else:  # CrossEntropy / CrossEntropy_BoundaryVar
                losses["loss_cls"] = cross_entropy_loss(*cls_args)
            reg_args = (flat(sampled["boxes"]), flat(sampled["gt_boxes"]), flat(bdeltas))
            fg_valid = (flat(sampled["is_fg"]), flat(sampled["valid"]))
            if pseudo:
                losses["loss_box_reg"] = _pseudo_box_reg(*reg_args, flat(bstd), flat(sampled["gt_loc_std"]),
                                                         *fg_valid)
            elif box_cfg.BBOX_REG_LOSS_TYPE == "nlloss":
                losses["loss_box_reg"] = box_reg_loss_nll(*reg_args, flat(bstd), *fg_valid, parts.roi_box2box,
                                                          box_cfg.SMOOTH_L1_BETA)
            else:  # smooth_l1
                losses["loss_box_reg"] = box_reg_loss_smooth_l1(*reg_args, *fg_valid, parts.roi_box2box,
                                                                box_cfg.SMOOTH_L1_BETA)
            out.append(losses)
        return out[0], out[1], counts

    def _labeled_views(batch, label_q, label_hw):
        """USE_SUP_STRONG "both": strong + weak labeled views; otherwise the
        weak view only (reference trainer.py:800-803, 861-864). -> (images,
        gt, hw, the views' row counts)."""
        bl = batch["images_label_k"].shape[0]
        if not sup_strong:
            return batch["images_label_k"], batch["gt_label"], label_hw, [bl]
        return (
            torch.cat([label_q, batch["images_label_k"]], 0),
            batch["gt_label"].map(lambda x: torch.cat([x, x], 0)),
            torch.cat([label_hw, label_hw], 0),
            [bl, bl],
        )

    def _detached(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in d.items()}

    def burnin_step(state: RCNNTrainState, batch: Dict[str, Any]):
        """Supervised-only step (reference trainer.py:775-812)."""
        _start()
        batch = float_images(batch)
        images_l = batch["images_label_k"]
        label_hw = hw_or_canvas(batch, "label_hw", images_l)
        label_q = strong_view(batch, "label", images_l) if sup_strong else None
        images, gt2, hw2, blocks = _labeled_views(batch, label_q, label_hw)
        sup, _, counts = _branches(state.student, images, gt2, hw2, batch, "sup", blocks, images.shape[0])
        total = sum(sup.values())
        sgd_step(state, total)
        metrics = _detached(sup)
        metrics["total_loss"] = total.detach()
        metrics.update(counts)
        return state, metrics

    def mutual_step(state: RCNNTrainState, batch: Dict[str, Any]):
        """Mutual-learning step (reference trainer.py:814-1023)."""
        _start()
        batch = float_images(batch)
        if state.step == burn_up:
            keep_rate = 0.0
        elif (state.step - burn_up) % sem.TEACHER_UPDATE_ITER == 0:
            keep_rate = sem.EMA_KEEP_RATE
        else:
            keep_rate = 1.0
        _ema_update(state.teacher, state.student, keep_rate)

        unl_k = batch["images_unlabel_k"]
        unlabel_hw = hw_or_canvas(batch, "unlabel_hw", unl_k)
        label_hw = hw_or_canvas(batch, "label_hw", batch["images_label_k"])
        if cfg.TPU.ORACLE_PSEUDO:
            # positive control: the unlabeled stream's ground truth
            pseudo = batch["gt_unlabel"]
        else:
            outputs = parts.box_outputs(state.teacher, unl_k, unlabel_hw)
            dets = parts.inference(outputs, unlabel_hw)
            pseudo = _pseudo_labels(dets)

        label_q = strong_view(batch, "label", batch["images_label_k"]) if sup_strong else None
        unl_q = strong_view(batch, "unlabel", unl_k)
        images_l, gt2, hw_l2, blocks = _labeled_views(batch, label_q, label_hw)
        if unl_q.shape[1:3] == images_l.shape[1:3]:
            # one student forward over labeled strong + weak and unlabeled
            # strong; the branches' losses reduce over row slices
            sup, unsup, counts = _branches(
                state.student, torch.cat([images_l, unl_q], 0), _cat_instances(gt2, pseudo),
                torch.cat([hw_l2, unlabel_hw], 0), batch, "sup", blocks + [unl_q.shape[0]], images_l.shape[0],
            )
        else:
            # mixed canvas buckets: one forward per canvas, the same math
            sup, _, counts = _branches(state.student, images_l, gt2, hw_l2, batch, "sup", blocks,
                                       images_l.shape[0])
            _, unsup, counts_u = _branches(state.student, unl_q, pseudo, unlabel_hw, batch, "unsup",
                                           [unl_q.shape[0]], 0)
            counts = {k: v + counts_u[k] for k, v in counts.items()}

        weighted = dict(sup)
        weighted["loss_rpn_loc_pseudo"] = unsup["loss_rpn_loc"] * 0.0
        weighted["loss_box_reg_pseudo"] = unsup["loss_box_reg"] * sem.UNSUP_REG_LOSS_WEIGHT
        weighted["loss_rpn_cls_pseudo"] = unsup["loss_rpn_cls"] * sem.UNSUP_LOSS_WEIGHT
        weighted["loss_cls_pseudo"] = unsup["loss_cls"] * sem.UNSUP_LOSS_WEIGHT
        total = sum(weighted.values())
        sgd_step(state, total)

        metrics = _detached(sup)
        metrics.update({k + "_pseudo": v.detach() for k, v in unsup.items()})
        metrics["total_loss"] = total.detach()
        metrics["ema_rate_1000x"] = torch.tensor(keep_rate, dtype=torch.float32) * 1000.0
        metrics["num_pseudo"] = pseudo.mask.sum()
        metrics.update(counts)
        return state, metrics

    return burnin_step, mutual_step


def make_rcnn_proposal_fn(cfg) -> Callable:
    """(model, images (B, H, W, 3), hw (B, 2)) -> (boxes (B, P, 4), objectness
    (B, P), mask (B, P)): RPN proposals at test settings, for the
    box-proposal AR path (reference: coco_evaluation.py:142-143 captures
    output['proposals'])."""
    parts = _RCNNParts(cfg)

    @torch.inference_mode()
    def proposals(model, images: torch.Tensor, hw: Optional[torch.Tensor] = None):
        images = images.float()
        if hw is None:
            hw = hw_or_canvas({}, "hw", images)
        hw = hw.float()
        _, logits, deltas, anch = parts.rpn(model, images, hw)
        return parts.top_proposals(anch, logits, deltas, hw, train=False)[:3]

    return proposals


def make_rcnn_inference_fn(cfg) -> Callable[[Any, torch.Tensor, torch.Tensor], Detections]:
    """(model, images (B, H, W, 3), hw (B, 2)) -> Detections: proposals at
    test settings, the box head and fast_rcnn_inference (reference: stock
    GeneralizedRCNN.inference)."""
    parts = _RCNNParts(cfg)

    def infer(model, images: torch.Tensor, hw: Optional[torch.Tensor] = None) -> Detections:
        images = images.float()
        if hw is None:
            hw = hw_or_canvas({}, "hw", images)
        return parts.detect(model, images, hw.float())

    return infer
