"""Reference-format weights -> the port's modules (PyTorch port of
ubteacher_tpu.checkpoint.torch_weights).

The reference bootstraps the student from detectron2's MSRA ImageNet pkl
("detectron2://ImageNetPretrained/MSRA/R-50.pkl", configs/*/coco-standard)
and saves EnsembleTSModel checkpoints (reference:
checkpoint/detection_checkpoint.py:10-89). The converters here map those
names onto the port's state_dict names, which mirror the JAX package's flax
paths joined with dots (see jax_params.py):

  * Caffe2 pkl names (conv1_w, res{s}_{b}_branch2{a,b,c}_w, *_bn_{s,b}): the
    `_bn_s`/`_bn_b` pairs are AffineChannel scale/bias, already-folded
    frozen BN, mapping 1:1 onto FrozenBN (scale, bias);
  * detectron2 module names (backbone.bottom_up.res2.0.conv1.weight,
    ...conv1.norm.{weight,bias,running_mean,running_var}): FrozenBN is
    folded, scale = gamma / sqrt(var + eps), bias = beta - mean * scale, in
    the JAX converter's numpy arithmetic.

Torch and the port share the layouts (conv OIHW, Linear (out, in)), so no
kernel is transposed; only the box head's fc1 input is permuted, because the
port's box head flattens ROI features (P, P, C) where torch flattens
(C, P, P). The converters return {port name: numpy array}; `cast_like`
turns them into tensors of a module's state_dict.
"""

from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch

from ..modeling.resnet import RESNET_STAGES

_BRANCH_TO_CONV = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3", "branch1": "shortcut"}


def load_c2_pickle(path: str) -> Dict[str, np.ndarray]:
    """A Caffe2 / detectron2 weight-zoo pickle -> {name: array}. Unpickling
    runs code from the file: load only weights from a trusted source."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "model" in data:
        data = data["model"]
    return {k: np.asarray(v) for k, v in data.items() if isinstance(v, np.ndarray) or hasattr(v, "shape")}


def convert_c2_resnet(weights: Mapping[str, np.ndarray], depth: int = 50) -> Dict[str, np.ndarray]:
    """Caffe2 MSRA names -> the port's ResNet names (relative to `backbone`)."""
    out = {
        "stem_conv1.weight": weights["conv1_w"],
        "stem_conv1_norm.scale": weights["res_conv1_bn_s"],
        "stem_conv1_norm.bias": weights["res_conv1_bn_b"],
    }
    for stage_idx, n in enumerate(RESNET_STAGES[depth]):
        s = stage_idx + 2  # res2..res5
        for b in range(n):
            for branch, conv in _BRANCH_TO_CONV.items():
                wk = f"res{s}_{b}_{branch}_w"
                if wk not in weights:
                    continue
                blk = f"res{s}_block{b}"
                out[f"{blk}.{conv}.weight"] = weights[wk]
                out[f"{blk}.{conv}_norm.scale"] = weights[f"res{s}_{b}_{branch}_bn_s"]
                out[f"{blk}.{conv}_norm.bias"] = weights[f"res{s}_{b}_{branch}_bn_b"]
    return out


def convert_d2_resnet(
    state_dict: Mapping[str, np.ndarray],
    depth: int = 50,
    prefix: str = "backbone.bottom_up.",
    eps: float = 1e-5,
) -> Dict[str, np.ndarray]:
    """detectron2 module-path names -> the port's ResNet names (relative to
    `backbone`), folding FrozenBN statistics into (scale, bias)."""

    def fold(base: str, ours: str) -> Dict[str, np.ndarray]:
        gamma = state_dict[f"{base}.weight"]
        beta = state_dict[f"{base}.bias"]
        mean = state_dict.get(f"{base}.running_mean")
        var = state_dict.get(f"{base}.running_var")
        if mean is None:  # already affine
            return {f"{ours}.scale": gamma, f"{ours}.bias": beta}
        scale = gamma / np.sqrt(var + eps)
        return {f"{ours}.scale": scale, f"{ours}.bias": beta - mean * scale}

    out = {"stem_conv1.weight": state_dict[f"{prefix}stem.conv1.weight"]}
    out.update(fold(f"{prefix}stem.conv1.norm", "stem_conv1_norm"))
    for stage_idx, n in enumerate(RESNET_STAGES[depth]):
        s = stage_idx + 2
        for b in range(n):
            blk = f"res{s}_block{b}"
            for conv in ("conv1", "conv2", "conv3"):
                base = f"{prefix}res{s}.{b}.{conv}"
                out[f"{blk}.{conv}.weight"] = state_dict[f"{base}.weight"]
                out.update(fold(f"{base}.norm", f"{blk}.{conv}_norm"))
            sc = f"{prefix}res{s}.{b}.shortcut"
            if f"{sc}.weight" in state_dict:
                out[f"{blk}.shortcut.weight"] = state_dict[f"{sc}.weight"]
                out.update(fold(f"{sc}.norm", f"{blk}.shortcut_norm"))
    return out


def _weight_bias(state_dict: Mapping[str, np.ndarray], base: str, ours: str) -> Dict[str, np.ndarray]:
    return {f"{ours}.weight": state_dict[f"{base}.weight"], f"{ours}.bias": state_dict[f"{base}.bias"]}


def convert_d2_fpn(state_dict: Mapping[str, np.ndarray], prefix: str = "backbone.") -> Dict[str, np.ndarray]:
    """detectron2 FPN names -> the port's FPN names (relative to `fpn`):
    lateral/output convs and the FCOS P6/P7 top block."""
    out: Dict[str, np.ndarray] = {}
    for stage in (2, 3, 4, 5):
        for kind in ("lateral", "output"):
            base = f"{prefix}fpn_{kind}{stage}"
            if f"{base}.weight" in state_dict:
                out.update(_weight_bias(state_dict, base, f"fpn_{kind}{stage}"))
    for blk, ours in (("top_block.p6", "top_block_p6"), ("top_block.p7", "top_block_p7")):
        if f"{prefix}{blk}.weight" in state_dict:
            out.update(_weight_bias(state_dict, f"{prefix}{blk}", ours))
    return out


def convert_ubt_fcos_head(state_dict: Mapping[str, np.ndarray],
                          prefix: str = "proposal_generator.fcos_head.") -> Dict[str, np.ndarray]:
    """Reference FCOSHead names (fcos.py:220-336: {cls,bbox,share}_tower.N,
    cls_logits, bbox_pred, bbox_pred_std, ctrness, scales.N.scale) -> the
    port's FCOSHead names ({cls,bbox,share}_conv{i} / _gn{i}, the same output
    heads, a `scales` vector), relative to `head`."""
    out: Dict[str, np.ndarray] = {}
    for tower, ours in (("cls_tower", "cls"), ("bbox_tower", "bbox"), ("share_tower", "share")):
        i = 0
        n = 0  # torch Sequential index: conv at 3k, GroupNorm at 3k + 1, ReLU at 3k + 2
        while f"{prefix}{tower}.{n}.weight" in state_dict:
            out.update(_weight_bias(state_dict, f"{prefix}{tower}.{n}", f"{ours}_conv{i}"))
            gn = f"{prefix}{tower}.{n + 1}"
            if f"{gn}.weight" in state_dict and state_dict[f"{gn}.weight"].ndim == 1:
                out.update(_weight_bias(state_dict, gn, f"{ours}_gn{i}"))
            i += 1
            n += 3
    for head in ("cls_logits", "bbox_pred", "bbox_pred_std", "ctrness"):
        if f"{prefix}{head}.weight" in state_dict:
            out.update(_weight_bias(state_dict, f"{prefix}{head}", head))
    scales = []
    n = 0
    while f"{prefix}scales.{n}.scale" in state_dict:
        scales.append(np.asarray(state_dict[f"{prefix}scales.{n}.scale"]).reshape(()))
        n += 1
    if scales:
        out["scales"] = np.stack(scales)
    return out


def _under(prefix: str, names: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in names.items()}


def convert_ubt_fcos_model(state_dict: Mapping[str, np.ndarray], depth: int = 50) -> Dict[str, np.ndarray]:
    """A reference OneStageDetector state dict -> the port's OneStageDetector
    state_dict names. Takes the teacher or student part of an
    EnsembleTSModel checkpoint (split_ensemble_state strips the
    'modelTeacher.' / 'modelStudent.' prefix)."""
    return {
        **_under("backbone", convert_d2_resnet(state_dict, depth)),
        **_under("fpn", convert_d2_fpn(state_dict)),
        **_under("head", convert_ubt_fcos_head(state_dict)),
    }


class TrackingStateDict(dict):
    """A dict that records which keys a converter read, so a caller can
    report the reference parameters that no port parameter took."""

    def __init__(self, data: Mapping):
        super().__init__(data)
        self.used: set = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if super().__contains__(k):
            self.used.add(k)
        return super().get(k, default)

    def unused(self, ignore_substrings=()) -> list:
        return sorted(k for k in self if k not in self.used and not any(s in k for s in ignore_substrings))


def convert_ubt_rcnn_model(
    state_dict: Mapping[str, np.ndarray], depth: int = 50, pooler_resolution: int = 7,
) -> Dict[str, np.ndarray]:
    """A reference TwoStagePseudoLabGeneralizedRCNN state dict -> the port's
    TwoStageRCNN state_dict names.

    Reference module names (D2 StandardRPNHead via PseudoLabRPN rpn.py:15;
    FastRCNNConvFCHead fc1/fc2; the *BoundaryVar predictors
    fast_rcnn.py:255-271 cls_score / bbox_pred / bbox_pred_std):
      proposal_generator.rpn_head.{conv,objectness_logits,anchor_deltas}
      roi_heads.box_head.fc{1,2}
      roi_heads.box_predictor.{cls_score,bbox_pred[,bbox_pred_std]}

    The R-CNN FPN has no P6/P7 convs (its top block is a parameter-free
    max-pool). fc1's input is permuted: torch flattens ROI features
    (C, P, P) channel-major, the port's box head (P, P, C)."""
    rpn = "proposal_generator.rpn_head."
    out = {
        **_under("backbone", convert_d2_resnet(state_dict, depth)),
        **_under("fpn", convert_d2_fpn(state_dict)),
    }
    for name in ("conv", "objectness_logits", "anchor_deltas"):
        out.update(_weight_bias(state_dict, f"{rpn}{name}", f"rpn_head.{name}"))

    bh = "roi_heads.box_head."
    w1 = np.asarray(state_dict[f"{bh}fc1.weight"])  # (D, C*P*P), channel-major
    d_out, p = w1.shape[0], pooler_resolution
    c = w1.shape[1] // (p * p)
    out["box_head.fc1.weight"] = np.ascontiguousarray(
        w1.reshape(d_out, c, p, p).transpose(0, 2, 3, 1).reshape(d_out, p * p * c)
    )
    out["box_head.fc1.bias"] = state_dict[f"{bh}fc1.bias"]
    i = 2
    while f"{bh}fc{i}.weight" in state_dict:
        out.update(_weight_bias(state_dict, f"{bh}fc{i}", f"box_head.fc{i}"))
        i += 1

    bp = "roi_heads.box_predictor."
    for name in ("cls_score", "bbox_pred", "bbox_pred_std"):
        if name != "bbox_pred_std" or f"{bp}{name}.weight" in state_dict:  # BoundaryVar variants
            out.update(_weight_bias(state_dict, f"{bp}{name}", f"box_predictor.{name}"))
    return out


def split_ensemble_state(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Dict]:
    """An EnsembleTSModel checkpoint -> {'teacher': sub_sd, 'student': sub_sd}
    (reference: ts_ensemble.py:6-16 holds modelTeacher/modelStudent; DDP
    'module.' prefixes are stripped like detection_checkpoint.py:24-28)."""
    out: Dict[str, Dict] = {"teacher": {}, "student": {}}
    for k, v in state_dict.items():
        for torch_name, ours in (("modelTeacher.", "teacher"), ("modelStudent.", "student")):
            if k.startswith(torch_name):
                sub = k[len(torch_name):]
                if sub.startswith("module."):
                    sub = sub[len("module."):]
                out[ours][sub] = v
    return out


def load_pretrained_backbone(model: torch.nn.Module, weights_path: str, depth: int = 50) -> torch.nn.Module:
    """Copy the converted weights of a Caffe2 or detectron2 backbone pickle
    into `model.backbone` in place (the student-only bootstrap; the teacher
    starts from the burn-in copy like the reference, trainer.py:213-214).
    Every converted name must exist in the backbone."""
    raw = load_c2_pickle(weights_path)
    converted = convert_c2_resnet(raw, depth) if "conv1_w" in raw else convert_d2_resnet(raw, depth)
    own = model.backbone.state_dict()
    missing = sorted(k for k in converted if k not in own)
    if missing:
        raise KeyError(f"backbone has no parameters {missing[:8]}")
    model.backbone.load_state_dict(cast_like(converted, own, partial=True), strict=False)
    return model


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint on disk -> {name: numpy array}.

    Takes torch .pth/.pt files (optionally wrapped as {"model": sd}, as a
    DetectionTSCheckpointer save) and pickle .pkl files (the D2 weight-zoo
    format), the formats DetectionTSCheckpointer reads (reference:
    checkpoint/detection_checkpoint.py:10-89). Both unpickle: load only
    checkpoints from a trusted source."""
    if path.endswith((".pth", ".pt")):
        raw = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(raw, dict) and "model" in raw:
            raw = raw["model"]
        if hasattr(raw, "state_dict"):
            raw = raw.state_dict()
        return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in raw.items() if hasattr(v, "shape")}
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin1")
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    return {k: np.asarray(v) for k, v in raw.items() if hasattr(v, "shape")}


def cast_like(converted: Mapping[str, np.ndarray], init: Mapping[str, torch.Tensor],
              partial: bool = False) -> Dict[str, torch.Tensor]:
    """Converted arrays -> tensors with the dtypes and shapes of a module's
    state_dict `init`; every name of `init` must be covered unless
    `partial`."""
    if not partial:
        missing = [k for k in init if k not in converted]
        if missing:
            raise ValueError(f"converter missed params: {missing[:8]}")
    return {
        k: torch.from_numpy(np.array(converted[k])).to(v.dtype).reshape(v.shape)
        for k, v in init.items() if k in converted
    }
