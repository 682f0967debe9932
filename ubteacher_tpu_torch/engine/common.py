"""Helpers shared by the step builders (PyTorch port of
ubteacher_tpu.engine.common)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..data.augment import apply_strong, draw_strong_params
from ..parallel import reduce_gradients, take_owned, world_size
from ..utils.events import span


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


def global_blocks(local_blocks: Sequence[int]) -> list:
    """The global batch's block sizes of local blocks (every rank holds the
    same number of rows of each stream)."""
    return [n * world_size() for n in local_blocks]


def owned_draws(draws, blocks: Sequence[int]):
    """Draws taken for the global batch (a dataclass of tensors whose leading
    axis is the global blocks `blocks`, e.g. StrongAugParams,
    SamplingDraws) -> this rank's rows of each block."""
    return type(draws)(**{f.name: take_owned(getattr(draws, f.name), blocks) for f in dataclasses.fields(draws)})


def sgd_step(state, total: torch.Tensor) -> None:
    """backward, the gradients summed over the ranks (parallel/dist.py's
    rule), one optimizer step; each in its span."""
    state.optimizer.zero_grad()
    with span("ubt.step.backward"):
        total.backward()
    reduce_gradients(state.student.parameters())
    with span("ubt.step.optimizer"):
        state.optimizer.step()
    state.step += 1


def strong_view(batch: dict, key: str, images: torch.Tensor) -> torch.Tensor:
    """The strong augmentation of this rank's rows of a stream, from draws
    for the global batch: batch[f"strong_{key}"] if the batch carries them,
    else drawn from batch["rng"] (the same seeded generator on every rank)."""
    blocks = global_blocks(images.shape[:1])
    draws = batch.get(f"strong_{key}")
    if draws is None:
        draws = draw_strong_params(blocks[0], *images.shape[1:3], batch["rng"])
    return apply_strong(images, owned_draws(draws, blocks))
