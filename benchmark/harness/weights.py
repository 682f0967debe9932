"""Seeded weights made on the device, in a few large calls, by a
configuration's init table, and handed alike to the program and to the
reference.

The table (`init` in `configs/<config>.json`) is a list of
[regex, kind, value] rules; a parameter takes the first rule whose regex
matches its full name. Kinds: `const` (fill with value), `normal` (std
value), `lecun` (std sqrt(1 / fan_in)), `fanin_uniform_std` (std
sqrt(1 / (3 fan_in)), the variance of U(-1/sqrt(fan_in), +)), `first`
(value[0] at index 0, value[1] elsewhere). Every random leaf is a slice of
one standard-normal draw from a torch.Generator on the device, so the
weights cost one kernel whatever the model's depth."""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Tuple

import torch


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


def rule_of(name: str, rules: List) -> Tuple[str, object]:
    for pattern, kind, value in rules:
        if re.fullmatch(pattern, name):
            return kind, value
    raise KeyError(f"no init rule matches the parameter {name!r}")


def make_weights(shapes: Iterable[Tuple[str, torch.Size]], rules: List, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{parameter name: float32 tensor on `device`} for the named shapes."""
    shapes = list(shapes)
    kinds = [rule_of(name, rules) for name, _ in shapes]
    random = [(name, shape, kind, value) for (name, shape), (kind, value) in zip(shapes, kinds)
              if kind in ("normal", "lecun", "fanin_uniform_std")]
    total = sum(math.prod(shape) for _, shape, _, _ in random)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    start = 0
    for name, shape, kind, value in random:
        n = math.prod(shape)
        std = {"normal": lambda: float(value), "lecun": lambda: math.sqrt(1.0 / _fan_in(shape)),
               "fanin_uniform_std": lambda: math.sqrt(1.0 / (3 * _fan_in(shape)))}[kind]()
        out[name] = noise[start:start + n].view(shape).mul_(std)
        start += n
    for (name, shape), (kind, value) in zip(shapes, kinds):
        if kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        elif kind == "first":
            t = torch.full(shape, float(value[1]), device=device)
            t[0] = float(value[0])
            out[name] = t
        elif name not in out:
            raise ValueError(f"unknown init kind {kind!r} for {name!r}")
    return out


def param_shapes(module: torch.nn.Module):
    return [(name, p.shape) for name, p in module.named_parameters()]


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into every parameter of `module` (all must be given)."""
    params = dict(module.named_parameters())
    missing = set(params) - set(weights)
    if missing:
        raise KeyError(f"no weights for {sorted(missing)[:4]}")
    for name, p in params.items():
        p.copy_(weights[name])
