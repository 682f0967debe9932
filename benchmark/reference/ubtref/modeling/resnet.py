"""ResNet backbone, detectron2-compatible caffe/MSRA variant (PyTorch port of
ubteacher_tpu.modeling.resnet).

Stem modes: "conv" (cuDNN conv, FrozenBN, ReLU, max-pool) and "pallas", the
fused stem of ops/stem.py (its CUDA kernel on the card). The fused stem reads
the image NHWC, which is the memory order of the NCHW view the detectors
pass in, and writes NHWC, whose NCHW view is channels-last: cuDNN takes it
as it is, so neither side copies.

Module and parameter names follow the flax tree of the JAX package
(`res2_block0.conv1.weight`, `stem_conv1_norm.scale`, ...) so that
checkpoint.params_from_jax is a renaming plus the HWIO -> OIHW transpose.
FrozenBatchNorm is the folded per-channel affine y = x * scale + bias; its
parameters never train (solver.build.freeze_parameters sets
requires_grad=False on them and on the stem/res2 stages).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stem import stem_conv_pool

# blocks per stage, keyed by depth
RESNET_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default conv init: truncated normal, variance 1 / fan_in."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class FrozenBN(nn.Module):
    """BatchNorm folded to y = x * scale + bias (stats frozen)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in the activation dtype, as the JAX module does (bf16 under autocast)
        return x * self.scale.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with FrozenBN; the caffe variant puts the
    stride on the 1x1 (STRIDE_IN_1X1=True)."""

    def __init__(self, cin: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, stride_in_1x1: bool = True, has_shortcut: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = _conv(cin, bottleneck_channels, 1, s1)
        self.conv1_norm = FrozenBN(bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, s3, 1)
        self.conv2_norm = FrozenBN(bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)
        self.conv3_norm = FrozenBN(out_channels)
        self.has_shortcut = has_shortcut
        if has_shortcut:
            self.shortcut = _conv(cin, out_channels, 1, stride)
            self.shortcut_norm = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1_norm(self.conv1(x)))
        out = F.relu(self.conv2_norm(self.conv2(out)))
        out = self.conv3_norm(self.conv3(out))
        sc = self.shortcut_norm(self.shortcut(x)) if self.has_shortcut else x
        return F.relu(out + sc)


class ResNet(nn.Module):
    """NCHW input -> {"res2": ..., "res5": ...} restricted to `out_features`."""

    STEM_MODES = ("conv", "pallas")
    # the JAX package's TPU-only stem modes (ROADMAP.md, "Do not port")
    UNPORTED_STEM_MODES = ("s2d", "im2col", "pallas_interpret")

    def __init__(self, depth: int = 50, out_features: Sequence[str] = ("res3", "res4", "res5"),
                 stride_in_1x1: bool = True, stem_out_channels: int = 64,
                 res2_out_channels: int = 256, in_channels: int = 3, stem_mode: str = "conv"):
        super().__init__()
        if stem_mode in self.UNPORTED_STEM_MODES:
            raise ValueError(f"stem_mode {stem_mode!r} is not ported (ROADMAP.md, 'Do not port'); "
                             f"the port runs {self.STEM_MODES}")
        if stem_mode not in self.STEM_MODES:
            raise ValueError(f"unknown stem_mode {stem_mode!r}; expected one of {self.STEM_MODES}")
        self.stem_mode = stem_mode
        self.out_features = tuple(out_features)
        self.stem_conv1 = _conv(in_channels, stem_out_channels, 7, 2, 3)
        self.stem_conv1_norm = FrozenBN(stem_out_channels)
        max_stage = max(int(f[3:]) for f in self.out_features if f.startswith("res"))
        out_ch, bott_ch, cin = res2_out_channels, res2_out_channels // 4, stem_out_channels
        self.stages = []  # [(stage name, [block names])]
        for stage_idx, n_blocks in enumerate(RESNET_STAGES[depth]):
            stage = f"res{stage_idx + 2}"
            if stage_idx + 2 > max_stage:
                break
            names = []
            for b in range(n_blocks):
                name = f"{stage}_block{b}"
                self.add_module(name, BottleneckBlock(
                    cin, out_ch, bott_ch,
                    stride=(1 if stage_idx == 0 else 2) if b == 0 else 1,
                    stride_in_1x1=stride_in_1x1, has_shortcut=(b == 0),
                ))
                names.append(name)
                cin = out_ch
            self.stages.append((stage, names))
            out_ch *= 2
            bott_ch *= 2

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_mode == "pallas":
            # the output dtype the conv mode gives: bf16 under autocast. The
            # kernel reads the NCHW batch through its (B, H, W, 3) view in
            # place: no NHWC copy
            dt = x.device.type
            dtype = torch.get_autocast_dtype(dt) if torch.is_autocast_enabled(dt) else torch.float32
            y = stem_conv_pool(x.permute(0, 2, 3, 1), self.stem_conv1.weight.permute(2, 3, 1, 0),
                               self.stem_conv1_norm.scale, self.stem_conv1_norm.bias, dtype)
            return y.permute(0, 3, 1, 2)
        x = F.relu(self.stem_conv1_norm(self.stem_conv1(x)))
        return F.max_pool2d(x, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outputs = {}
        for stage, names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_features:
                outputs[stage] = x
        return outputs


def resnet_from_cfg(cfg) -> ResNet:
    r = cfg.MODEL.RESNETS
    return ResNet(
        depth=r.DEPTH,
        out_features=tuple(r.OUT_FEATURES),
        stride_in_1x1=r.STRIDE_IN_1X1,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stem_mode="s2d" if cfg.TPU.STEM_SPACE_TO_DEPTH else cfg.TPU.STEM_MODE,
    )
