"""The port's learning check (ubteacher_tpu_torch/tools/learning_sanity.py)
against the JAX package's tools/learning_sanity.py: the same synthetic COCO
set, bitwise (images and JSON); the same config, key for key; and a tiny
two-arm ablation on the CPU that prints the JAX tool's JSON keys plus
"device". The lift itself runs on the card (tests/test_torch_fcos_lift.py,
opt-in)."""

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from test_torch_config import _flat
from torch_parity import (  # noqa: F401 (few_torch_threads, tmp_budget: autouse fixtures)
    few_torch_threads,
    tmp_budget,
)
from ubteacher_tpu_torch.tools import learning_sanity as port

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import learning_sanity as ref  # noqa: E402  (the repo root on sys.path first)

# the ablation recipe of tests/test_fcos_lift.py, and the positive control
RECIPE = dict(steps=1000, burnin=600, size=128, images=64, label_images=8, jitter=40, seed=0)
# a tiny run on the CPU: R-18 in float32, 2 + 2 images on 64x64 canvases
TINY_OPTS = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32",
             "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2"]


@pytest.mark.parametrize("seed,jitter", [(0, 0), (0, 40), (5, 0), (5, 40)])
def test_synthetic_coco_bitwise_equal(tmp_path, seed, jitter):
    got = port.synthetic_coco(tmp_path / "port", 12, 128, seed=seed, color_jitter=jitter)
    want = ref.synthetic_coco(tmp_path / "ref", 12, 128, seed=seed, color_jitter=jitter)
    assert Path(got[0]).read_bytes() == Path(want[0]).read_bytes()
    assert Path(got[1]).name == Path(want[1]).name == "images"
    g = {Path(k).name: v for k, v in got[2].items()}
    w = {Path(k).name: v for k, v in want[2].items()}
    assert g.keys() == w.keys() and len(g) == 12
    for name, img in w.items():
        assert g[name].dtype == img.dtype == np.uint8 and np.array_equal(g[name], img), name


@pytest.mark.parametrize("rcnn", [False, True], ids=["fcos", "rcnn"])
@pytest.mark.parametrize("extra", [{}, {"bbox_thresh": 0.6, "oracle_pseudo": True}], ids=["recipe", "thresh_oracle"])
def test_build_cfg_equal_key_for_key(tmp_path, monkeypatch, rcnn, extra):
    monkeypatch.chdir(ROOT)  # the JAX tool reads its yaml relative to the repo root
    args = types.SimpleNamespace(rcnn=rcnn, opts=["TPU.STEM_MODE", "pallas"], **RECIPE, **extra)
    out = str(tmp_path / "out")
    for burnin in (None, 1000):
        want = _flat(ref.build_cfg(args, out, burnin=burnin))
        got = _flat(port.build_cfg(args, out, burnin=burnin))
        assert got == want
        assert got["SEMISUPNET.BURN_UP_STEP"] == (burnin or 600)
    assert got["TPU.ORACLE_PSEUDO"] == extra.get("oracle_pseudo", False)


class _StubTrainer:
    """Stands in for the JAX trainers: the JAX tool's JSON keys without
    training (a JAX mutual step compiles for minutes on this CPU)."""

    def __init__(self, cfg, datasets=None, image_loader=None):
        self.cfg = cfg

    def train(self):
        os.makedirs(self.cfg.OUTPUT_DIR, exist_ok=True)
        if self.cfg.SEMISUPNET.BURN_UP_STEP < self.cfg.SOLVER.MAX_ITER:
            with open(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json"), "w") as f:
                f.write(json.dumps({"num_pseudo_cls": 3.0, "num_pseudo": 3.0}) + "\n")

    def test(self, model="teacher"):
        return {"AP": 1.0}


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_tiny_ablation_prints_the_jax_tools_keys(tmp_path, monkeypatch, capsys):
    from ubteacher_tpu.engine import trainer as jax_trainer

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(jax_trainer, "UBTeacherTrainer", _StubTrainer)
    argv = ["--ablation", "--steps", "4", "--burnin", "2", "--size", "64", "--images", "12", "--label-images", "4",
            "--opts"] + TINY_OPTS
    monkeypatch.setattr(sys, "argv", ["learning_sanity.py"] + argv)
    want = ref.main() or json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    got = port.main(argv + ["--cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert got["device"] == "cpu"
    assert _keys(got) == dict(_keys(want), device=None)
    assert {k: got[k] for k in ("ablation", "detector", "label_images", "unlabel_images", "steps", "burnin")} == \
        {k: want[k] for k in ("ablation", "detector", "label_images", "unlabel_images", "steps", "burnin")}
    for arm in ("sup", "ssod"):
        assert np.isfinite(got[arm]["ap_student"])
    # the SSOD arm's mutual steps ran: the pseudo-box count was recorded
    assert got["ssod"]["mean_pseudo_boxes"] is not None and np.isfinite(got["ssod"]["ap_teacher"])
    assert got["sup"]["mean_pseudo_boxes"] is None


def test_sanity_run_needs_two_streams():
    with pytest.raises(SystemExit):
        port.main(["--images", "8", "--cpu"])
