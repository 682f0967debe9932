"""FCOS target assignment, losses and dense decoding (PyTorch port of
ubteacher_tpu.modeling.fcos_outputs).

Same fixed-shape design as the JAX package: per-location work is vectorized
over a (B, L, MAX_GT) grid with masks, losses are masked sums over all L
locations, and decoding emits padded Detections. The batch dimension is
written out where the JAX package vmaps. The focal and GIoU losses go
through the hand-written kernels (ops/kernels), NMS through the CUDA kernel
behind ops.nms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..ops import boxes as box_ops
from ..ops import losses as L
from ..ops.kernels.focal_triton import sigmoid_focal_loss
from ..ops.kernels.giou_cuda import giou_loss
from ..ops.nms import batched_nms_keep, top_k_detections
from ..parallel import all_reduce_sum
from ..structures import Detections, PaddedInstances

INF = 100000000.0


# --------------------------------------------------------------------------
# static geometry
# --------------------------------------------------------------------------


def level_feature_sizes(
    canvas_hw: Tuple[int, int], strides: Sequence[int]
) -> List[Tuple[int, int]]:
    """Feature (H, W) per FPN level for a fixed canvas."""
    h, w = canvas_hw
    return [(-(-h // s), -(-w // s)) for s in strides]


def compute_locations(
    canvas_hw: Tuple[int, int], strides: Sequence[int], device: torch.device | str = "cuda"
) -> Dict[str, torch.Tensor]:
    """All-level location grid for a fixed canvas: locations (L, 2) (x, y) at
    stride/2 offsets, strides (L,), size_ranges (L, 2), level_ids (L,)."""
    sizes = level_feature_sizes(canvas_hw, strides)
    soi: List[Tuple[float, float]] = []
    prev = -1.0
    for s in (64.0, 128.0, 256.0, 512.0):
        soi.append((prev, s))
        prev = s
    soi.append((prev, INF))
    locs, strs, ranges, lids = [], [], [], []
    for lvl, ((fh, fw), stride) in enumerate(zip(sizes, strides)):
        ys = torch.arange(fh, dtype=torch.float32, device=device) * stride + stride // 2
        xs = torch.arange(fw, dtype=torch.float32, device=device) * stride + stride // 2
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        locs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        n = fh * fw
        strs.append(torch.full((n,), float(stride), device=device))
        # filled on the device: a tensor copied from pageable host memory
        # would make the host wait for the device
        lo, hi = (torch.full((n,), float(v), device=device) for v in soi[lvl])
        ranges.append(torch.stack([lo, hi], -1))
        lids.append(torch.full((n,), lvl, dtype=torch.int32, device=device))
    return {
        "locations": torch.cat(locs, 0),
        "strides": torch.cat(strs, 0),
        "size_ranges": torch.cat(ranges, 0),
        "level_ids": torch.cat(lids, 0),
    }


def location_validity(grid: Dict[str, torch.Tensor], image_hw: torch.Tensor) -> torch.Tensor:
    """(B, L) bool: locations whose cell origin lies inside the true image."""
    x0 = grid["locations"][:, 0] - grid["strides"] * 0.5
    y0 = grid["locations"][:, 1] - grid["strides"] * 0.5
    hw = image_hw.float()
    return (x0[None, :] < hw[:, 1:2]) & (y0[None, :] < hw[:, 0:1])


# --------------------------------------------------------------------------
# target assignment
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FCOSTargets:
    """Per-location training targets for one batch. All (B, L, ...)."""

    labels: torch.Tensor         # (B, L) int64 in [0, C]; C = background
    reg_targets: torch.Tensor    # (B, L, 4) ltrb / stride
    box_weights: torch.Tensor    # (B, L)
    boundary_vars: torch.Tensor  # (B, L, 4) teacher reg std carried to locations
    keep: torch.Tensor           # (B, L) bool, ignore_near keep mask
    pos: torch.Tensor            # (B, L) bool, foreground


def fcos_assign_targets(
    grid: Dict[str, torch.Tensor],
    gt: PaddedInstances,
    num_classes: int,
    center_sample: bool,
    radius: float,
    ignore_near: bool = False,
    image_hw: torch.Tensor | None = None,
) -> FCOSTargets:
    """Masked (B, L, M) assignment (reference fcos_outputs.py:772-906): per-gt
    area cost, INF-masked by in-box / size-of-interest / validity, first
    argmin as the tie-break. `image_hw` (B, 2) drops locations outside each
    image's true extent from `keep` (and hence `pos`)."""
    locations = grid["locations"]       # (L, 2)
    loc_strides = grid["strides"]       # (L,)
    size_ranges = grid["size_ranges"]   # (L, 2)
    boxes = gt.boxes                    # (B, M, 4)
    valid = gt.mask                     # (B, M)
    b, m = valid.shape
    num_loc = locations.shape[0]

    ltrb = box_ops.encode_ltrb(locations[None, :, None, :], boxes[:, None, :, :])  # (B, L, M, 4)

    if center_sample:
        cx = (boxes[..., 0] + boxes[..., 2]) * 0.5  # (B, M)
        cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
        r = (loc_strides * radius)[None, :, None]   # (1, L, 1)
        xmin = torch.maximum(cx[:, None, :] - r, boxes[:, None, :, 0])
        ymin = torch.maximum(cy[:, None, :] - r, boxes[:, None, :, 1])
        xmax = torch.minimum(cx[:, None, :] + r, boxes[:, None, :, 2])
        ymax = torch.minimum(cy[:, None, :] + r, boxes[:, None, :, 3])
        xs = locations[None, :, 0:1]
        ys = locations[None, :, 1:2]
        is_in_boxes = torch.stack(
            [xs - xmin, ys - ymin, xmax - xs, ymax - ys], dim=-1
        ).amin(-1) > 0
    else:
        is_in_boxes = ltrb.amin(-1) > 0  # (B, L, M)

    max_ltrb = ltrb.amax(-1)
    cared = (max_ltrb >= size_ranges[None, :, 0:1]) & (max_ltrb <= size_ranges[None, :, 1:2])

    area = box_ops.area(boxes)  # (B, M)
    cost = torch.where(
        is_in_boxes & cared & valid[:, None, :],
        area[:, None, :].expand(b, num_loc, m),
        torch.full((), INF, device=area.device),
    )
    min_area, min_idx = cost.min(-1)  # first minimum, as jnp.argmin
    is_bg = min_area >= INF

    # the argmin gt per location; a gather picks exactly what the JAX
    # one-hot contraction sums to
    labels_sel = torch.gather(gt.classes, 1, min_idx)
    labels = torch.where(is_bg, torch.full_like(labels_sel, num_classes), labels_sel)
    reg_targets = torch.gather(ltrb, 2, min_idx[..., None, None].expand(b, num_loc, 1, 4))[:, :, 0]
    reg_targets = reg_targets / loc_strides[None, :, None]

    # background box weight is 1.0; an image with no valid gt gets zeros
    any_gt = valid.any(-1)[:, None]  # (B, 1)
    box_weights = torch.where(is_bg, 1.0, torch.gather(gt.scores, 1, min_idx))
    box_weights = torch.where(any_gt, box_weights, 0.0)
    sel_std = torch.gather(gt.box_std, 1, min_idx[..., None].expand(b, num_loc, 4))
    boundary_vars = torch.where(is_bg[..., None], 99999.0, sel_std)
    boundary_vars = torch.where(any_gt[..., None], boundary_vars, 0.0)

    if ignore_near:
        # drop background locations inside ANY gt box that were not selected
        # as centers (reference fcos_outputs.py:841-848)
        in_any_box = ((ltrb.amin(-1) > 0) & valid[:, None, :]).any(-1)
        keep_fg = (is_in_boxes & valid[:, None, :]).any(-1)
        keep = (~in_any_box | keep_fg) & any_gt
    else:
        keep = torch.ones((b, num_loc), dtype=torch.bool, device=boxes.device)
    if image_hw is not None:
        keep = keep & location_validity(grid, image_hw)
    pos = (labels != num_classes) & keep
    return FCOSTargets(
        labels=labels,
        reg_targets=reg_targets,
        box_weights=box_weights,
        boundary_vars=boundary_vars,
        keep=keep,
        pos=pos,
    )


# --------------------------------------------------------------------------
# dense head outputs
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FCOSDense:
    """Concatenated-over-levels dense head outputs: logits (B, L, C); reg
    (B, L, 4) stride units, or (B, L, 4*(R+1)) bin logits when reg_discrete;
    ctrness (B, L); reg_std (B, L, 4)."""

    logits: torch.Tensor
    reg: torch.Tensor
    ctrness: torch.Tensor
    reg_std: torch.Tensor

    def split(self, n: int) -> Tuple["FCOSDense", "FCOSDense"]:
        """Split along the batch at n."""
        fields = [getattr(self, f.name) for f in dataclasses.fields(self)]
        return FCOSDense(*(x[:n] for x in fields)), FCOSDense(*(x[n:] for x in fields))


def integral_project(reg_bins: torch.Tensor, reg_max: int) -> torch.Tensor:
    """GFL Integral: softmax over (R+1) bins -> expected offset.
    (..., 4*(R+1)) -> (..., 4)."""
    p = torch.softmax(reg_bins.reshape(*reg_bins.shape[:-1], 4, reg_max + 1), dim=-1)
    proj = torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)
    return (p * proj).sum(-1)


def dense_reg_scalar(dense: FCOSDense, reg_discrete: bool, reg_max: int) -> torch.Tensor:
    if reg_discrete:
        return integral_project(dense.reg, reg_max)
    return dense.reg


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """jax.nn.one_hot semantics: label == num_classes (background) is a
    zero row."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def _focal_sum(logits: torch.Tensor, labels: torch.Tensor, cfg_fcos: Dict[str, Any]) -> torch.Tensor:
    """(B, L, C) logits, (B, L) labels -> per-location focal sum (B, L),
    through the focal kernel on (B*L, C) rows."""
    c = logits.shape[-1]
    per_elem = sigmoid_focal_loss(
        logits.reshape(-1, c).contiguous(),
        _one_hot(labels, c).reshape(-1, c),
        alpha=cfg_fcos["loss_alpha"],
        gamma=cfg_fcos["loss_gamma"],
    )
    return per_elem.sum(-1).reshape(labels.shape)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def fcos_supervised_losses(
    dense: FCOSDense, targets: FCOSTargets, cfg_fcos: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    """Supervised losses (reference fcos_outputs.py:307-444): focal cls over
    all kept locations / num positives, centerness BCE, IoU-family regression
    weighted by ctrness targets / loss_denorm, and the optional KL/NLL term,
    with KLLOSS_WEIGHT applied twice as the reference does. The normalizers
    are counts over the global batch (the rule of parallel/dist.py; the JAX
    step's batch is global under pjit)."""
    keep_f = targets.keep.float()
    pos_f = targets.pos.float()
    num_pos = all_reduce_sum(pos_f.sum())
    num_pos_avg = torch.clamp(num_pos, min=1.0)

    cls_all = _focal_sum(dense.logits, targets.labels, cfg_fcos)
    class_loss = (cls_all * keep_f).sum() / num_pos_avg

    reg_pred = dense_reg_scalar(dense, cfg_fcos["reg_discrete"], cfg_fcos["reg_max"])
    # background rows carry the argmin gt's (possibly degenerate) ltrb; unit
    # boxes off-positives keep inf * 0 out of the masked formulas
    safe_reg_targets = torch.where(targets.pos[..., None], targets.reg_targets, 1.0)

    if cfg_fcos["quality_est"] == "centerness":
        ctr_targets = L.compute_ctrness_targets(safe_reg_targets)
    else:  # 'iou'
        ctr_targets = L.compute_iou_targets(reg_pred.detach(), safe_reg_targets)
    ctr_targets = ctr_targets * pos_f
    loss_denorm = torch.clamp(all_reduce_sum(ctr_targets.sum()), min=1e-6)

    iou_targets = L.compute_iou_targets(reg_pred.detach(), safe_reg_targets)

    ctr_loss = (L.bce_with_logits(dense.ctrness, ctr_targets) * pos_f).sum() / num_pos_avg

    if cfg_fcos["loc_loss_type"] == "giou":
        iou_sum = giou_loss(reg_pred, safe_reg_targets, ctr_targets)
    else:
        iou_sum = L.iou_loss(reg_pred, safe_reg_targets, ctr_targets, cfg_fcos["loc_loss_type"])
    iou_reg_loss = iou_sum / loss_denorm

    if cfg_fcos["kl_loss"]:
        w = cfg_fcos["kl_loss_weight"]
        if cfg_fcos["kl_loss_type"] == "nlloss":
            unc = L.nl_loss(reg_pred, dense.reg_std, safe_reg_targets,
                            iou_weight=iou_targets, valid=pos_f)
        elif cfg_fcos["kl_loss_type"] == "klloss":
            unc = L.kl_loss(reg_pred, dense.reg_std, safe_reg_targets,
                            weight=ctr_targets, loss_denorm=loss_denorm,
                            method=cfg_fcos["loc_fun_all"], valid=pos_f)
        else:
            raise ValueError(cfg_fcos["kl_loss_type"])
        # double application of the weight is intentional (reference parity)
        reg_loss = w * (w * unc) + iou_reg_loss
    else:
        reg_loss = iou_reg_loss

    # no-positives guard (the reference zeroes reg/ctr when there are none)
    has_pos = num_pos > 0
    zero = reg_loss.new_zeros(())
    return {
        "loss_fcos_cls": class_loss,
        "loss_fcos_loc": torch.where(has_pos, reg_loss, zero),
        "loss_fcos_ctr": torch.where(has_pos, ctr_loss, zero),
    }


def fcos_pseudo_losses(
    dense: FCOSDense,
    cls_targets: FCOSTargets,
    reg_targets: FCOSTargets,
    cfg_fcos: Dict[str, Any],
    ts_better: float,
    ts_better_cert: float,
    consist_reg_loss: str = "ts_locvar_better_nms_nll_l1",
) -> Dict[str, torch.Tensor]:
    """Unlabeled-branch losses (reference fcos_outputs.py:492-631): focal
    cls + centerness BCE from the `cls` pseudo set; regression from the
    `reg` pseudo set, either the Listen2Student uncertainty-gated L1
    (`ts_locvar_better_nms_nll_l1`, the shipped recipe) or the KL/NLL pseudo
    regression loss (any other value). Normalizers, and the branches taken on
    counts, are global as in fcos_supervised_losses; teacher_better_student
    is this rank's count of selected edges."""
    pos_f = cls_targets.pos.float()
    keep_f = cls_targets.keep.float()
    num_pos = all_reduce_sum(pos_f.sum())
    num_pos_avg = torch.clamp(num_pos, min=1.0)

    cls_all = _focal_sum(dense.logits, cls_targets.labels, cfg_fcos)
    class_loss = (cls_all * keep_f).sum() / num_pos_avg

    safe_cls_reg = torch.where(cls_targets.pos[..., None], cls_targets.reg_targets, 1.0)
    ctr_t = L.compute_ctrness_targets(safe_cls_reg) * pos_f
    ctr_loss = (L.bce_with_logits(dense.ctrness, ctr_t) * pos_f).sum() / num_pos_avg
    ctr_loss = torch.where(num_pos > 0, ctr_loss, ctr_loss.new_zeros(()))
    if cfg_fcos.get("unify_ctrcls", False):
        ctr_loss = ctr_loss * 0.0

    reg_pos = reg_targets.pos
    reg_pos_f = reg_pos.float()
    reg_pred = dense_reg_scalar(dense, cfg_fcos["reg_discrete"], cfg_fcos["reg_max"])
    if not cfg_fcos["kl_loss"]:
        raise ValueError("FCOS pseudo regression loss requires MODEL.FCOS.KL_LOSS=True")

    if consist_reg_loss == "ts_locvar_better_nms_nll_l1":
        loc_conf_student = 1.0 - torch.sigmoid(dense.reg_std)
        loc_conf_teacher = 1.0 - torch.sigmoid(reg_targets.boundary_vars)
        select = (
            (loc_conf_teacher > ts_better_cert)
            & (loc_conf_teacher > loc_conf_student + ts_better)
            & reg_pos[..., None]
        )
        select_f = select.float()
        n_select = select_f.sum()
        n_select_all = all_reduce_sum(n_select)
        # F.smooth_l1_loss(beta=0) == L1, 'mean' over the selected elements
        l1 = torch.abs(reg_pred - reg_targets.reg_targets) * select_f
        reg_loss = torch.where(
            n_select_all > 0, l1.sum() / torch.clamp(n_select_all, min=1.0), l1.new_zeros(())
        )
    else:
        # KL/NLL pseudo regression with the weight applied ONCE
        # (reference fcos_outputs.py:571-585)
        w = cfg_fcos["kl_loss_weight"]
        safe_reg = torch.where(reg_pos[..., None], reg_targets.reg_targets, 1.0)
        ctr_reg = L.compute_ctrness_targets(safe_reg) * reg_pos_f
        loss_denorm = torch.clamp(all_reduce_sum(ctr_reg.sum()), min=1e-6)
        iou_t = L.compute_iou_targets(reg_pred.detach(), safe_reg)
        if cfg_fcos["kl_loss_type"] == "nlloss":
            unc = L.nl_loss(reg_pred, dense.reg_std, safe_reg, iou_weight=iou_t, valid=reg_pos_f)
        elif cfg_fcos["kl_loss_type"] == "klloss":
            unc = L.kl_loss(reg_pred, dense.reg_std, safe_reg, weight=ctr_reg,
                            loss_denorm=loss_denorm, method=cfg_fcos["loc_fun_all"],
                            valid=reg_pos_f)
        else:
            raise ValueError(cfg_fcos["kl_loss_type"])
        reg_loss = torch.where(all_reduce_sum(reg_pos_f.sum()) > 0, w * unc, unc.new_zeros(()))
        n_select = reg_loss.new_zeros(())

    return {
        "loss_fcos_cls": class_loss,
        "loss_fcos_ctr": ctr_loss,
        "loss_fcos_loc": reg_loss,
        "teacher_better_student": n_select,
    }


# --------------------------------------------------------------------------
# decoding (dense -> padded Detections)
# --------------------------------------------------------------------------


def _method_scores(cls_sig: torch.Tensor, ctr_sig: torch.Tensor, std: torch.Tensor,
                   nms_method: str) -> torch.Tensor:
    """(B, L, C), (B, L), (B, L, 4) -> NMS-criterion scores (B, L, C)."""
    if nms_method == "cls_n_ctr":
        return cls_sig * ctr_sig[..., None]
    if nms_method == "cls":
        return cls_sig
    if nms_method == "ctr":
        return ctr_sig[..., None].expand_as(cls_sig)
    if nms_method == "cls_n_loc":
        loc_conf = (1.0 - torch.sigmoid(std)).mean(-1)
        return cls_sig * loc_conf[..., None]
    raise ValueError(f"Undefined nms criteria: {nms_method}")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: x (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


@torch.no_grad()
def fcos_decode(
    dense: FCOSDense,
    grid: Dict[str, torch.Tensor],
    level_lengths: Sequence[int],
    image_hw: torch.Tensor,
    cfg_fcos: Dict[str, Any],
    nms_method: str,
    pre_nms_thresh: float,
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_thresh: float,
    total_candidates: int,
) -> Detections:
    """Dense outputs -> padded per-image Detections: per-level two-stage
    top-k, a global candidate cap, class-aware NMS over all B images in one
    kernel launch, and post-NMS top-k (reference fcos_outputs.py:1046-1320)."""
    reg_scalar = dense_reg_scalar(dense, cfg_fcos["reg_discrete"], cfg_fcos["reg_max"])
    regp = reg_scalar * grid["strides"][None, :, None]
    cls_s = torch.sigmoid(dense.logits)   # (B, L, C)
    ctr_s = torch.sigmoid(dense.ctrness)  # (B, L)
    std = dense.reg_std
    b, num_loc, num_classes = cls_s.shape
    hw = image_hw.float()

    # drop candidates whose location lies beyond the true image extent
    loc_valid = location_validity(grid, hw)  # (B, L)
    if cfg_fcos.get("thresh_with_ctr", False):
        cls_s = cls_s * ctr_s[..., None]
        scores = cls_s
    else:
        scores = _method_scores(cls_s, ctr_s, std, nms_method)
    cand = (cls_s > pre_nms_thresh) & loc_valid[..., None]
    masked = torch.where(cand, scores, torch.full((), -1.0, device=scores.device))

    # per-level top-k over (len_l * C) candidates, two-stage and exact: the
    # top-K pairs lie in the top-K locations by per-location max
    sel_scores, sel_loc, sel_cls = [], [], []
    offset = 0
    for ln in level_lengths:
        k = min(pre_nms_topk, ln * num_classes)
        lvl_scores = masked[:, offset:offset + ln]            # (B, ln, C)
        k_loc = min(pre_nms_topk, ln)
        _, loc_sel = torch.topk(lvl_scores.amax(-1), k_loc, dim=-1)   # (B, k_loc)
        flat = _take(lvl_scores, loc_sel).reshape(b, -1)     # (B, k_loc * C)
        top, idx = torch.topk(flat, k, dim=-1)
        sel_scores.append(top)
        sel_loc.append(torch.gather(loc_sel, 1, idx // num_classes) + offset)
        sel_cls.append(idx % num_classes)
        offset += ln
    scores_c = torch.cat(sel_scores, 1)
    loc_c = torch.cat(sel_loc, 1)
    cls_c = torch.cat(sel_cls, 1)

    # global candidate cap before NMS
    cap = min(total_candidates, scores_c.shape[1])
    valid_pre = scores_c > 0.0
    top, idx = torch.topk(torch.where(valid_pre, scores_c, -1.0), cap, dim=-1)
    loc_c = torch.gather(loc_c, 1, idx)
    cls_c = torch.gather(cls_c, 1, idx)
    valid_c = top > 0.0
    scores_c = top

    boxes_c = box_ops.decode_ltrb(grid["locations"][loc_c], _take(regp, loc_c))
    ctr_c = torch.gather(ctr_s, 1, loc_c)
    conf_c = torch.gather(_take(cls_s, loc_c), 2, cls_c[..., None])[..., 0]
    std_c = _take(std, loc_c)

    if nms_method in ("cls_n_ctr", "cls_n_loc"):
        final_scores = torch.sqrt(torch.clamp(scores_c, min=0.0))
    else:
        final_scores = scores_c

    keep = batched_nms_keep(boxes_c, final_scores, cls_c, valid_c, nms_thresh)
    k_post = min(post_nms_topk, final_scores.shape[1])
    idx2, mask = top_k_detections(keep, final_scores, k_post)
    out_boxes = box_ops.clip_boxes(_take(boxes_c, idx2), hw[:, 0:1], hw[:, 1:2])
    zero = torch.zeros((), device=mask.device)
    return Detections(
        boxes=out_boxes,
        scores=torch.where(mask, torch.gather(final_scores, 1, idx2), zero),
        classes=torch.gather(cls_c, 1, idx2),
        cls_confid=torch.where(mask, torch.gather(conf_c, 1, idx2), zero),
        centerness=torch.gather(ctr_c, 1, idx2),
        box_std=_take(std_c, idx2),
        mask=mask,
        num_candidates=valid_c.sum(-1),
    )


def threshold_pseudo_labels(dets: Detections, thresh: float, max_boxes: int) -> PaddedInstances:
    """scores > thresh -> pseudo ground truth (reference pseudo_generator.py:
    62-105); the box capacity is sliced or zero-padded to `max_boxes`."""
    keep = dets.mask & (dets.scores > thresh)
    k = dets.boxes.shape[1]

    def fit(x: torch.Tensor) -> torch.Tensor:
        if k >= max_boxes:
            return x[:, :max_boxes]
        pad = x.new_zeros((x.shape[0], max_boxes - k) + x.shape[2:])
        return torch.cat([x, pad], 1)

    return PaddedInstances(
        boxes=fit(dets.boxes),
        classes=fit(dets.classes),
        scores=fit(dets.scores),
        box_std=fit(dets.box_std),
        mask=fit(keep),
    )


def threshold_pseudo_labels_cls_ctr(
    dets: Detections, cls_thresh: float, ctr_thresh: float, max_boxes: int
) -> PaddedInstances:
    """cls_confid > t0 AND centerness > t1 -> pseudo ground truth (reference
    pseudo_generator.py:107-131)."""
    keep = dets.mask & (dets.cls_confid > cls_thresh) & (dets.centerness > ctr_thresh)
    return threshold_pseudo_labels(dataclasses.replace(dets, mask=keep), -1.0, max_boxes)


def fcos_loss_config(cfg) -> Dict[str, Any]:
    """The static FCOS loss/decode settings of a CfgNode."""
    f = cfg.MODEL.FCOS
    return {
        "num_classes": f.NUM_CLASSES,
        "loss_alpha": f.LOSS_ALPHA,
        "loss_gamma": f.LOSS_GAMMA,
        "loc_loss_type": f.LOC_LOSS_TYPE,
        "quality_est": f.QUALITY_EST,
        "reg_discrete": f.REG_DISCRETE,
        "reg_max": f.REG_MAX,
        "kl_loss": f.KL_LOSS,
        "kl_loss_type": f.KL_LOSS_TYPE,
        "kl_loss_weight": f.KLLOSS_WEIGHT,
        "loc_fun_all": f.LOC_FUN_ALL,
        "center_sample": f.CENTER_SAMPLE,
        "pos_radius": f.POS_RADIUS,
        "thresh_with_ctr": f.THRESH_WITH_CTR,
        "unify_ctrcls": f.UNIFY_CTRCLS,
    }
