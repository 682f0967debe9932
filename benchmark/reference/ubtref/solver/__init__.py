from .build import (
    Optimizer,
    build_lr_schedule,
    build_optimizer,
    freeze_parameters,
    trainable_mask,
)

__all__ = [
    "Optimizer",
    "build_lr_schedule",
    "build_optimizer",
    "freeze_parameters",
    "trainable_mask",
]
