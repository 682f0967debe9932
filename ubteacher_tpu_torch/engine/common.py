"""Helpers shared by the step builders (PyTorch port of
ubteacher_tpu.engine.common)."""

from __future__ import annotations

import torch


def image_hw(images: torch.Tensor) -> torch.Tensor:
    """(B, 2) float32 of the full canvas size."""
    b, h, w = images.shape[:3]
    return torch.tensor([h, w], dtype=torch.float32, device=images.device).expand(b, 2)


def hw_or_canvas(batch: dict, key: str, images: torch.Tensor) -> torch.Tensor:
    """(B, 2) float32 true per-image sizes; the full canvas when the batch
    ships none (synthetic batches, direct step calls)."""
    hw = batch.get(key)
    if hw is None:
        return image_hw(images)
    return hw.float()


def float_images(batch: dict) -> dict:
    """Cast the batch's image tensors to float32 at step entry (a loader may
    ship raw uint8 pixels)."""
    out = dict(batch)
    for k in ("images_label_k", "images_unlabel_k"):
        v = out.get(k)
        if v is not None and not v.is_floating_point():
            out[k] = v.float()
    return out
