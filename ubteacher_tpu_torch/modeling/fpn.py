"""Feature Pyramid Network (PyTorch port of ubteacher_tpu.modeling.fpn), with
the FCOS P6/P7 top block (P6 a stride-2 conv fed from p5, P7 a stride-2 conv
of relu(p6), reference backbone/fpn.py:65) or the Faster R-CNN one (P6 a
1x1-window, stride-2 max pool of p5, detectron2 LastLevelMaxPool)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import lecun_normal_


class FPN(nn.Module):
    """in_features e.g. ("res3", "res4", "res5") -> {"p3": ..., "p7": ...}."""

    def __init__(self, in_channels: Dict[str, int], in_features: Sequence[str] = ("res3", "res4", "res5"),
                 out_channels: int = 256, top_block: str = "p6p7", fuse_type: str = "sum"):
        super().__init__()
        if top_block not in ("p6p7", "maxpool"):
            raise ValueError(f"top_block must be 'p6p7' or 'maxpool', got {top_block!r}")
        self.top_block = top_block
        self.in_features = tuple(in_features)
        self.stages = [int(f[3:]) for f in self.in_features]
        self.fuse_type = fuse_type
        for f, s in zip(self.in_features, self.stages):
            self.add_module(f"fpn_lateral{s}", nn.Conv2d(in_channels[f], out_channels, 1))
            self.add_module(f"fpn_output{s}", nn.Conv2d(out_channels, out_channels, 3, padding=1))
        if top_block == "p6p7":
            self.top_block_p6 = nn.Conv2d(out_channels, out_channels, 3, stride=2, padding=1)
            self.top_block_p7 = nn.Conv2d(out_channels, out_channels, 3, stride=2, padding=1)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [
            getattr(self, f"fpn_lateral{s}")(bottom_up[f])
            for f, s in zip(self.in_features, self.stages)
        ]
        results = [None] * len(laterals)
        prev = laterals[-1]
        results[-1] = prev
        for i in range(len(laterals) - 2, -1, -1):
            prev = laterals[i] + F.interpolate(prev, scale_factor=2.0, mode="nearest")
            if self.fuse_type == "avg":
                prev = prev / 2.0
            results[i] = prev
        outputs = {
            f"p{s}": getattr(self, f"fpn_output{s}")(results[i])
            for i, s in enumerate(self.stages)
        }
        top = self.stages[-1]
        if self.top_block == "maxpool":
            outputs[f"p{top + 1}"] = F.max_pool2d(outputs[f"p{top}"], kernel_size=1, stride=2)
            return outputs
        p6 = self.top_block_p6(outputs[f"p{top}"])
        outputs[f"p{top + 1}"] = p6
        outputs[f"p{top + 2}"] = self.top_block_p7(F.relu(p6))
        return outputs


def fpn_from_cfg(cfg, in_channels: Dict[str, int], top_block: str = "p6p7") -> FPN:
    return FPN(
        in_channels=in_channels,
        in_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        top_block=top_block,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
    )
