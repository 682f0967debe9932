"""Box-to-box transforms (PyTorch port of
ubteacher_tpu.modeling.box_regression).

Box2BoxTransform: the Fast R-CNN (dx, dy, dw, dh) parameterisation of
detectron2, used by the RPN.

Box2BoxXYXYTransform: the per-edge (dl, dr, dd, du) parameterisation of the
BoundaryVar box head (reference box_regression.py:12-129), quirks kept:
get_deltas normalises by width + 1 while apply_deltas normalises by width,
and l/r share the wx weight while top/bottom share wy.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)
_XYXY_SCALE_CLAMP = 1000.0 / 16


class Box2BoxTransform:
    """(dx, dy, dw, dh) deltas, detectron2-compatible."""

    def __init__(self, weights: Tuple[float, float, float, float], scale_clamp: float = _DEFAULT_SCALE_CLAMP):
        self.weights = weights
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        sw = src_boxes[..., 2] - src_boxes[..., 0]
        sh = src_boxes[..., 3] - src_boxes[..., 1]
        scx = src_boxes[..., 0] + 0.5 * sw
        scy = src_boxes[..., 1] + 0.5 * sh
        tw = target_boxes[..., 2] - target_boxes[..., 0]
        th = target_boxes[..., 3] - target_boxes[..., 1]
        tcx = target_boxes[..., 0] + 0.5 * tw
        tcy = target_boxes[..., 1] + 0.5 * th
        wx, wy, ww, wh = self.weights
        sw = torch.clamp(sw, min=1e-6)
        sh = torch.clamp(sh, min=1e-6)
        dx = wx * (tcx - scx) / sw
        dy = wy * (tcy - scy) / sh
        dw = ww * torch.log(torch.clamp(tw, min=1e-6) / sw)
        dh = wh * torch.log(torch.clamp(th, min=1e-6) / sh)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """deltas (..., k*4), boxes (..., 4) -> (..., k*4)."""
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        cx = boxes[..., 0] + 0.5 * w
        cy = boxes[..., 1] + 0.5 * h
        wx, wy, ww, wh = self.weights
        dx = deltas[..., 0::4] / wx
        dy = deltas[..., 1::4] / wy
        dw = torch.clamp(deltas[..., 2::4] / ww, max=self.scale_clamp)
        dh = torch.clamp(deltas[..., 3::4] / wh, max=self.scale_clamp)
        pcx = dx * w[..., None] + cx[..., None]
        pcy = dy * h[..., None] + cy[..., None]
        pw = torch.exp(dw) * w[..., None]
        ph = torch.exp(dh) * h[..., None]
        out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
        return out.reshape(deltas.shape)


class Box2BoxXYXYTransform:
    """Per-edge deltas (dl, dr, dd, du)."""

    def __init__(self, weights: Tuple[float, float, float, float], scale_clamp: float = _XYXY_SCALE_CLAMP):
        self.weights = weights
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        src_w = src_boxes[..., 2] - src_boxes[..., 0] + 1.0
        src_h = src_boxes[..., 3] - src_boxes[..., 1] + 1.0
        wx, wy, _, _ = self.weights
        dl = wx * (target_boxes[..., 0] - src_boxes[..., 0]) / src_w
        dr = wx * (target_boxes[..., 2] - src_boxes[..., 2]) / src_w
        dd = wy * (target_boxes[..., 1] - src_boxes[..., 1]) / src_h
        du = wy * (target_boxes[..., 3] - src_boxes[..., 3]) / src_h
        return torch.stack([dl, dr, dd, du], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """deltas (..., k*4) in (dl, dr, dd, du) order -> xyxy (..., k*4)."""
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        wx, wy, _, _ = self.weights
        c = self.scale_clamp
        dl = torch.clamp(deltas[..., 0::4] / wx, -c, c)
        dr = torch.clamp(deltas[..., 1::4] / wx, -c, c)
        dd = torch.clamp(deltas[..., 2::4] / wy, -c, c)
        du = torch.clamp(deltas[..., 3::4] / wy, -c, c)
        pl = dl * w[..., None] + boxes[..., 0:1]
        pr = dr * w[..., None] + boxes[..., 2:3]
        pd = dd * h[..., None] + boxes[..., 1:2]
        pu = du * h[..., None] + boxes[..., 3:4]
        out = torch.stack([pl, pd, pr, pu], dim=-1)
        return out.reshape(deltas.shape)
