"""The port's config tree against ubteacher_tpu's: the defaults agree key for
key and value for value, and every shipped yaml loads into both alike."""

import glob
import os

import pytest

from ubteacher_tpu.config import add_ubteacher_config, get_cfg
from ubteacher_tpu_torch.config import add_ubteacher_config as t_add_ubteacher_config
from ubteacher_tpu_torch.config import get_cfg as t_get_cfg

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "**", "*.yaml"),
                           recursive=True))


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _both():
    cfgs = []
    for get, add in ((get_cfg, add_ubteacher_config), (t_get_cfg, t_add_ubteacher_config)):
        cfg = get()
        add(cfg)
        cfgs.append(cfg)
    return cfgs


def test_default_trees_agree():
    jcfg, tcfg = _both()
    assert _flat(tcfg) == _flat(jcfg)
    assert _flat(t_get_cfg()) == _flat(get_cfg())


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_yamls_load_alike(path):
    jcfg, tcfg = _both()
    jcfg.merge_from_file(path)
    tcfg.merge_from_file(path)
    assert _flat(tcfg) == _flat(jcfg)
