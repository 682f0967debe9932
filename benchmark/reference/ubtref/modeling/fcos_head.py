"""FCOS head + one-stage detector (PyTorch port of
ubteacher_tpu.modeling.fcos_head).

The head runs per FPN level with shared weights; its outputs are cast to
float32, flattened level by level in (h, w) row-major order and concatenated
into one (B, L, ...) FCOSDense, the layout of the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import mask_canvas_padding
from .fcos_outputs import FCOSDense
from .fpn import FPN, fpn_from_cfg
from .resnet import ResNet, resnet_from_cfg


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major over (h, w)."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


class FCOSHead(nn.Module):
    """Shared-weight per-level head: GN towers, Scale, GFL bins (REG_DISCRETE),
    bbox_pred_std (KL_LOSS) and the focal prior bias on cls_logits."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, num_levels: int = 5,
                 num_cls_convs: int = 4, num_box_convs: int = 4, num_share_convs: int = 0,
                 norm: str = "GN", use_scale: bool = True, reg_discrete: bool = False,
                 reg_max: int = 16, kl_loss: bool = True, prior_prob: float = 0.01):
        super().__init__()
        self.num_classes = num_classes
        self.norm = norm
        self.use_scale = use_scale
        self.reg_discrete = reg_discrete
        self.kl_loss = kl_loss
        self.prior_prob = prior_prob
        self.towers = {}
        for prefix, n in (("share", num_share_convs), ("cls", num_cls_convs), ("bbox", num_box_convs)):
            names = []
            for i in range(n):
                self.add_module(f"{prefix}_conv{i}", nn.Conv2d(in_channels, 256, 3, padding=1))
                names.append(f"{prefix}_conv{i}")
                if norm == "GN":
                    self.add_module(f"{prefix}_gn{i}", nn.GroupNorm(32, 256, eps=1e-5))
                    names.append(f"{prefix}_gn{i}")
                in_channels = 256
            self.towers[prefix] = names
        self.cls_logits = nn.Conv2d(256, num_classes, 3, padding=1)
        reg_out = 4 * (reg_max + 1) if reg_discrete else 4
        self.bbox_pred = nn.Conv2d(256, reg_out, 3, padding=1)
        if kl_loss:
            self.bbox_pred_std = nn.Conv2d(256, 4, 3, padding=1)
        self.ctrness = nn.Conv2d(256, 1, 3, padding=1)
        if use_scale:
            self.scales = nn.Parameter(torch.ones(num_levels))

    def init_weights(self, generator: torch.Generator) -> None:
        for name, m in self.named_children():
            if isinstance(m, nn.Conv2d):
                std = 0.0001 if name == "bbox_pred_std" else 0.01
                nn.init.normal_(m.weight, 0.0, std, generator=generator)
                nn.init.zeros_(m.bias)
        nn.init.constant_(self.cls_logits.bias, -math.log((1 - self.prior_prob) / self.prior_prob))

    def _run_tower(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        for name in self.towers[prefix]:
            layer = getattr(self, name)
            x = layer(x)
            if isinstance(layer, nn.GroupNorm) or self.norm != "GN":
                x = F.relu(x)
        return x

    def forward(self, features: List[torch.Tensor]) -> FCOSDense:
        logits_all, reg_all, ctr_all, std_all = [], [], [], []
        for lvl, feat in enumerate(features):
            x = self._run_tower("share", feat)
            ct = self._run_tower("cls", x)
            bt = self._run_tower("bbox", x)
            logits = self.cls_logits(ct).float()
            ctr = self.ctrness(bt).float()
            reg = self.bbox_pred(bt).float()
            if self.use_scale:
                reg = reg * self.scales[lvl]
            if not self.reg_discrete:
                reg = F.relu(reg)
            logits_all.append(_flatten(logits))
            reg_all.append(_flatten(reg))
            ctr_all.append(_flatten(ctr)[..., 0])
            if self.kl_loss:
                std_all.append(_flatten(self.bbox_pred_std(bt).float()))
            else:
                std_all.append(torch.zeros_like(_flatten(reg)[..., :4]))
        return FCOSDense(
            logits=torch.cat(logits_all, 1),
            reg=torch.cat(reg_all, 1),
            ctrness=torch.cat(ctr_all, 1),
            reg_std=torch.cat(std_all, 1),
        )


class OneStageDetector(nn.Module):
    """ResNet + FPN (P3-P7) + FCOS head -> FCOSDense.

    Images are (B, H, W, 3) float BGR in [0, 255]; normalization runs in
    float32 inside the model, and the canvas beyond each image's true (h, w)
    is zeroed after normalization when `hw` is given."""

    def __init__(self, backbone: ResNet, fpn: FPN, head: FCOSHead,
                 in_features: Sequence[str] = ("p3", "p4", "p5", "p6", "p7"),
                 pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675),
                 pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.backbone = backbone
        self.fpn = fpn
        self.head = head
        self.in_features = tuple(in_features)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        self.fpn.init_weights(generator)
        self.head.init_weights(generator)

    def forward(self, images: torch.Tensor, hw: torch.Tensor | None = None) -> FCOSDense:
        x = (images.float() - self.pixel_mean) / self.pixel_std
        if hw is not None:
            x = mask_canvas_padding(x, hw)
        feats = self.backbone(x.permute(0, 3, 1, 2))
        pyramid = self.fpn(feats)
        return self.head([pyramid[f] for f in self.in_features])


def build_one_stage_detector(cfg, device: torch.device | str = "cuda",
                             generator: torch.Generator | None = None) -> OneStageDetector:
    """Build the detector on `device` (the card unless the caller asks for the
    CPU); weights are drawn on the CPU from `generator` (flax's initializers:
    lecun-normal convs in the backbone and FPN, N(0, 0.01) head convs, the
    focal prior bias), then moved."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_one_stage_detector: no CUDA device; pass device='cpu' to build on the CPU")
    f = cfg.MODEL.FCOS
    backbone = resnet_from_cfg(cfg)
    res2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    in_channels = {f"res{k}": res2 * 2 ** (k - 2) for k in range(2, 6)}
    head = FCOSHead(
        in_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        num_classes=f.NUM_CLASSES,
        num_levels=len(f.IN_FEATURES),
        num_cls_convs=f.NUM_CLS_CONVS,
        num_box_convs=f.NUM_BOX_CONVS,
        num_share_convs=f.NUM_SHARE_CONVS,
        norm=f.NORM,
        use_scale=f.USE_SCALE,
        reg_discrete=f.REG_DISCRETE,
        reg_max=f.REG_MAX,
        kl_loss=f.KL_LOSS,
        prior_prob=f.PRIOR_PROB,
    )
    model = OneStageDetector(
        backbone=backbone,
        fpn=fpn_from_cfg(cfg, in_channels),
        head=head,
        in_features=tuple(f.IN_FEATURES),
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model.init_weights(generator)
    return model.to(device)
