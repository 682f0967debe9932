"""Carry a flax parameter tree of the JAX package into the port.

`params_from_jax` turns the nested {name: ... {leaf: array}} tree that
`ubteacher_tpu`'s OneStageDetector.init returns (as numpy arrays) into the
port's state_dict: conv kernels HWIO -> OIHW, FrozenBN `scale`/`bias`
unchanged, flax GroupNorm `GroupNorm_0/{scale,bias}` -> `weight`/`bias`, and
the head's per-level `scales` vector unchanged. The port's module names
mirror the flax names, so the rest is joining the path with dots.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax FCOS parameter tree (numpy leaves) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            arr = np.array(value, dtype=np.float32)  # a writable copy
            parts = [p for p in path if p != "GroupNorm_0"]
            in_gn = "GroupNorm_0" in path
            if key == "kernel":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                leaf = "weight"
            elif in_gn and key == "scale":
                leaf = "weight"
            else:
                leaf = key
            out[".".join(parts + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, ())
    return out
