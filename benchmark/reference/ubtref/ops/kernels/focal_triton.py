"""Sigmoid focal loss: the plain version, on any device."""

from __future__ import annotations

from .. import losses


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Per-element sigmoid focal loss, differentiable in `logits` only."""
    return losses.sigmoid_focal_loss(logits, targets.detach(), alpha, gamma)
