"""A configuration file's flat `cfg` keys applied to a CfgNode (the port's
or the reference's: both keep detectron2's nested attribute layout)."""

from __future__ import annotations

from typing import Any, Dict


def _coerce(value: Any, old: Any) -> Any:
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(_coerce(v, None) for v in value)
    if isinstance(value, list):
        return [_coerce(v, None) for v in value]
    return value


def apply(cfg, flat: Dict[str, Any]) -> None:
    """Set every `A.B.C` key of `flat` on `cfg`; a key the node lacks
    raises (a configuration names only keys the program has)."""
    for key, value in flat.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        if leaf not in node:
            raise KeyError(f"the config has no key {key}")
        node[leaf] = _coerce(value, node[leaf])


def build(cfg_module, flat: Dict[str, Any], extra: Dict[str, Any]):
    """get_cfg() + the UBTeacher keys of `cfg_module` (the port's config
    package or the reference's), then `flat`, then `extra` (the run's own
    keys: seed, output directory, dtype)."""
    cfg = cfg_module.get_cfg()
    cfg_module.add_ubteacher_config(cfg)
    apply(cfg, flat)
    apply(cfg, extra)
    cfg.freeze()
    return cfg
