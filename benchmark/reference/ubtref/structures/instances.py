"""Fixed-shape instance containers (PyTorch port of
ubteacher_tpu.structures.instances).

Instances live in padded (B, M, ...) tensors with a boolean validity mask;
target assignment, NMS and the losses are masked rather than gathered.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PaddedInstances:
    """Ground-truth or pseudo-label boxes for a batch of images.

    boxes (B, M, 4) xyxy in canvas pixels; classes (B, M) int64 in
    [0, num_classes); scores (B, M); box_std (B, M, 4) the teacher's raw
    per-boundary uncertainty logits; mask (B, M) bool validity.
    """

    boxes: torch.Tensor
    classes: torch.Tensor
    scores: torch.Tensor
    box_std: torch.Tensor
    mask: torch.Tensor

    @property
    def num_valid(self) -> torch.Tensor:
        return self.mask.sum(-1)

    def map(self, fn) -> "PaddedInstances":
        """Apply `fn` to every field (the port's jax.tree.map)."""
        return PaddedInstances(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


@dataclasses.dataclass
class Detections:
    """Padded post-NMS detections for a batch of images.

    boxes (B, K, 4) xyxy in canvas pixels; scores (B, K) the NMS-criterion
    score; classes (B, K); cls_confid (B, K) raw class sigmoid; centerness
    (B, K); box_std (B, K, 4); mask (B, K); num_candidates (B,) the number of
    valid candidates that entered NMS (no JAX counterpart: the port reports
    it as a step metric).
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    cls_confid: torch.Tensor
    centerness: torch.Tensor
    box_std: torch.Tensor
    mask: torch.Tensor
    num_candidates: torch.Tensor
