"""A minimal yacs-compatible config node (copy of ubteacher_tpu.config.cfg).

The reference uses yacs `CfgNode` through detectron2 (reference:
ubteacher/config.py:7, train_net.py:19-25). yacs is not available in this
environment, so we provide a compatible subset: attribute access, yaml
loading with ``_BASE_`` inheritance, ``merge_from_list`` CLI overrides,
freeze/defrost and clone.
"""

from __future__ import annotations

import ast
import copy
import io
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"
_VALID_SCALARS = (int, float, bool, str, type(None))


def _is_valid_value(v: Any) -> bool:
    if isinstance(v, _VALID_SCALARS):
        return True
    if isinstance(v, (list, tuple)):
        return all(_is_valid_value(x) for x in v)
    return isinstance(v, (dict, CfgNode))


class CfgNode(dict):
    """dict with attribute access and yacs-style semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(
            f"Non-existent config key: {name}. Available: {sorted(self.keys())}"
        )

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        if not _is_valid_value(value):
            raise ValueError(f"Invalid type {type(value)} for config key {name}")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name}, but CfgNode is immutable"
            )
        dict.__setitem__(self, name, value)

    # -- mutability ---------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    # -- merging ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self)

    def merge_from_file(self, filename: str, allow_unsafe: bool = True) -> None:
        loaded = _load_yaml_with_base(filename)
        _merge_a_into_b(CfgNode(loaded), self)

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            d = self
            for sub in keys[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent key: {full_key}")
                d = d[sub]
            last = keys[-1]
            if last not in d:
                raise KeyError(f"Non-existent key: {full_key}")
            d[last] = _decode_and_coerce(v, d[last], full_key)

    # -- io -----------------------------------------------------------------
    def dump(self, **kwargs) -> str:
        def _to_dict(node):
            if isinstance(node, CfgNode):
                return {k: _to_dict(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return list(node)
            return node

        with io.StringIO() as f:
            yaml.safe_dump(_to_dict(self), f, **kwargs)
            return f.getvalue()

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _decode_and_coerce(value_str: str, original: Any, full_key: str) -> Any:
    """Parse a CLI string and check type compatibility with the default."""
    try:
        value = ast.literal_eval(value_str)
    except (ValueError, SyntaxError):
        value = value_str  # plain string
    if original is None or value is None:
        return value
    if isinstance(original, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(original, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(original, bool):
        if isinstance(value, bool):
            return value
        raise ValueError(f"Type mismatch for {full_key}: expected bool, got {value!r}")
    if isinstance(original, float) and isinstance(value, int):
        return float(value)
    if type(value) is type(original) or isinstance(original, CfgNode):
        return value
    raise ValueError(
        f"Type mismatch for {full_key}: expected {type(original).__name__}, "
        f"got {value!r} ({type(value).__name__})"
    )


def _coerce_loaded(value: Any, original: Any) -> Any:
    if isinstance(original, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(value, str) and isinstance(original, (tuple, list)):
        # yacs allows "(a, b)" strings in yaml for tuples
        parsed = ast.literal_eval(value)
        return tuple(parsed) if isinstance(original, tuple) else list(parsed)
    if isinstance(original, float) and isinstance(value, int):
        return float(value)
    return value


def _merge_a_into_b(a: CfgNode, b: CfgNode) -> None:
    for k, v_a in a.items():
        if k in b:
            v_b = b[k]
            if isinstance(v_b, CfgNode) and isinstance(v_a, (dict, CfgNode)):
                _merge_a_into_b(CfgNode(v_a) if not isinstance(v_a, CfgNode) else v_a, v_b)
            else:
                dict.__setitem__(b, k, _coerce_loaded(v_a, v_b))
        else:
            v = CfgNode(v_a) if isinstance(v_a, dict) else v_a
            dict.__setitem__(b, k, v)


def _load_yaml_with_base(filename: str) -> Dict:
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    base_file = cfg.pop(_BASE_KEY, None)
    if base_file is not None:
        if not os.path.isabs(base_file):
            base_file = os.path.join(os.path.dirname(filename), base_file)
        base = _load_yaml_with_base(base_file)
        _dict_merge(cfg, base)
        return base
    return cfg


def _dict_merge(src: Dict, dst: Dict) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _dict_merge(v, dst[k])
        else:
            dst[k] = v
