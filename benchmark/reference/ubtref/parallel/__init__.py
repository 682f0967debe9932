"""The port's data-parallel helpers in a world of one process, which is all
the reference runs in: every row of a batch is owned, and every collective
gives back its input (the port's own without a process group)."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch


def world_size() -> int:
    return 1


def rank() -> int:
    return 0


def owned_rows(n: int, index: Optional[int] = None, count: Optional[int] = None) -> slice:
    """The rows [index*n/count, (index+1)*n/count) of a global batch of n
    that rank `index` of `count` owns (default: all of them); a batch that
    `count` does not divide raises."""
    count = world_size() if count is None else count
    index = rank() if index is None else index
    if n % count:
        raise ValueError(f"batch size {n} not divisible by the {count} processes")
    chunk = n // count
    return slice(index * chunk, (index + 1) * chunk)


def take_owned(x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
    return x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    return None
