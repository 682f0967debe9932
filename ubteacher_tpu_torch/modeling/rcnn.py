"""Two-stage pseudo-label Faster R-CNN (PyTorch port of
ubteacher_tpu.modeling.rcnn; reference meta_arch/rcnn.py:7-72).

The module holds the parametric pieces (backbone, FPN with the max-pool P6,
RPN head, box head, box predictor) and exposes the three stages the train
steps call: `features`, `rpn` and `roi_box`. Branch orchestration lives in
engine/rcnn_trainer.py. Submodule and parameter names follow the flax tree,
so checkpoint.params_from_jax carries a JAX initialisation across.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..ops.boxes import mask_canvas_padding
from ..ops.roi_align import multilevel_roi_align
from .fast_rcnn import BoundaryVarOutputLayers, FastRCNNConvFCHead
from .fpn import FPN, fpn_from_cfg
from .resnet import ResNet, resnet_from_cfg
from .rpn import RPNHead


class TwoStageRCNN(nn.Module):
    def __init__(self, backbone: ResNet, fpn: FPN, rpn_head: RPNHead, box_head: FastRCNNConvFCHead,
                 box_predictor: BoundaryVarOutputLayers,
                 rpn_in_features: Sequence[str] = ("p2", "p3", "p4", "p5", "p6"),
                 roi_in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 pooler_resolution: int = 7, pooler_sampling_ratio: int = 0,
                 pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675),
                 pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.backbone = backbone
        self.fpn = fpn
        self.rpn_head = rpn_head
        self.box_head = box_head
        self.box_predictor = box_predictor
        self.rpn_in_features = tuple(rpn_in_features)
        self.roi_in_features = tuple(roi_in_features)
        self.pooler_resolution = pooler_resolution
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.backbone, self.fpn, self.rpn_head, self.box_head, self.box_predictor):
            m.init_weights(generator)

    def features(self, images: torch.Tensor, hw: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) BGR [0, 255] -> the pyramid {"p2": (B, C, H/4, W/4),
        ...}; normalised in float32, the canvas beyond each image's true hw
        zeroed after normalisation."""
        x = (images.float() - self.pixel_mean) / self.pixel_std
        if hw is not None:
            x = mask_canvas_padding(x, hw)
        return self.fpn(self.backbone(x.permute(0, 3, 1, 2)))

    def rpn(self, pyramid: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> objectness (B, L, A) and deltas (B, L, A, 4), float32, the
        locations of all levels concatenated in anchor order."""
        logits, deltas = self.rpn_head([pyramid[f] for f in self.rpn_in_features])
        return torch.cat(logits, 1), torch.cat(deltas, 1)

    def roi_box(self, pyramid: Dict[str, torch.Tensor], boxes: torch.Tensor):
        """boxes (B, R, 4) -> scores (B, R, K + 1), deltas (B, R, 4),
        deltas_std (B, R, 4), float32."""
        pooled = multilevel_roi_align(
            [pyramid[f] for f in self.roi_in_features], boxes,
            [int(f[1:]) for f in self.roi_in_features],
            self.pooler_resolution, self.pooler_sampling_ratio,
        )
        return self.box_predictor(self.box_head(pooled))


def build_two_stage_rcnn(cfg, device: torch.device | str = "cpu",
                         generator: torch.Generator | None = None) -> TwoStageRCNN:
    """Build the detector on `device`; weights are drawn on the CPU from
    `generator` with the flax initialisers of the JAX package, then moved."""
    res2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    in_channels = {f"res{k}": res2 * 2 ** (k - 2) for k in range(2, 6)}
    fpn_dim = cfg.MODEL.FPN.OUT_CHANNELS
    p = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    fc_dim = cfg.MODEL.ROI_BOX_HEAD.FC_DIM
    num_cell_anchors = len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]) * len(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0])
    model = TwoStageRCNN(
        backbone=resnet_from_cfg(cfg),
        fpn=fpn_from_cfg(cfg, in_channels, top_block="maxpool"),
        rpn_head=RPNHead(fpn_dim, num_cell_anchors),
        box_head=FastRCNNConvFCHead(p * p * fpn_dim, fc_dim, cfg.MODEL.ROI_BOX_HEAD.NUM_FC),
        box_predictor=BoundaryVarOutputLayers(
            fc_dim, cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG,
        ),
        rpn_in_features=tuple(cfg.MODEL.RPN.IN_FEATURES),
        roi_in_features=tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES),
        pooler_resolution=p,
        pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model.init_weights(generator)
    return model.to(device)
