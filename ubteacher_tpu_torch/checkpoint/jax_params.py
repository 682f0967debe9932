"""Carry a flax parameter tree of the JAX package into the port.

`params_from_jax` turns the nested {name: ... {leaf: array}} tree that
`ubteacher_tpu`'s OneStageDetector.init or TwoStageRCNN.init returns (as
numpy arrays) into the port's state_dict: 4-d conv kernels HWIO -> OIHW
(including the RPN's 1x1 `_Conv1x1Params` kernels (1, 1, C, n)), 2-d Dense
kernels (in, out) -> Linear weights (out, in), FrozenBN `scale`/`bias`
unchanged, flax GroupNorm `GroupNorm_0/{scale,bias}` -> `weight`/`bias`, and
the FCOS head's per-level `scales` vector unchanged. The port's module names
mirror the flax names, so the rest is joining the path with dots.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax FCOS or R-CNN parameter tree (numpy leaves) -> the port's
    state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            arr = np.array(value, dtype=np.float32)  # a writable copy
            parts = [p for p in path if p != "GroupNorm_0"]
            in_gn = "GroupNorm_0" in path
            if key == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                leaf = "weight"
            elif key == "kernel" and arr.ndim == 2:
                arr = arr.T  # Dense (in, out) -> Linear (out, in)
                leaf = "weight"
            elif key == "kernel":
                raise ValueError(f"{'/'.join(path)}: a {arr.ndim}-d kernel has no counterpart")
            elif in_gn and key == "scale":
                leaf = "weight"
            else:
                leaf = key
            out[".".join(parts + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, ())
    return out
