"""The port's recipe mix (ubteacher_tpu_torch/tools/recipe_mix.py) against
the JAX package's tools/recipe_mix.py: the canvas bucket probabilities
replayed through each package's weak_augment_geometry over the marginal
COCO sizes are equal exactly (counts over the same draws), and so is the
JSON record with measured ms a step."""

import json
import sys
from pathlib import Path

import pytest

from ubteacher_tpu_torch.tools import bench_loader, recipe_mix

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import bench_loader as jax_bench_loader  # noqa: E402  (the repo root on sys.path first)
from tools import recipe_mix as jax_recipe_mix  # noqa: E402


@pytest.fixture
def no_coco(tmp_path, monkeypatch):
    """No annotation file under COCO_ROOT (the marginal approximation);
    the repo root as the working directory, where the JAX tool reads its
    config."""
    monkeypatch.setenv("COCO_ROOT", str(tmp_path))
    monkeypatch.chdir(ROOT)


def test_coco_like_dims_are_the_jax_tools():
    assert bench_loader.COCO_LIKE_DIMS == jax_bench_loader.COCO_LIKE_DIMS


@pytest.mark.parametrize("seed", [0, 3])
def test_bucket_probs_equal_jax(no_coco, seed):
    got = recipe_mix.bucket_probs(2000, seed=seed)
    assert got == jax_recipe_mix.bucket_probs(2000, seed=seed)
    assert set(got) == {"768x1344", "1024x1344"} and abs(sum(got.values()) - 1.0) < 1e-12


@pytest.mark.parametrize("ms", [[], ["768", "1344", "250.5", "1024", "1344", "331.25"], ["1344", "768", "250.5"]],
                         ids=["probabilities", "weighted", "missing"])
def test_record_equals_jax(no_coco, monkeypatch, capsys, ms):
    """main's JSON line, with --ms for both buckets (the portrait order
    folds), one, or none."""
    argv = ["--n", "500"] + [x for i in range(0, len(ms), 3) for x in ["--ms"] + ms[i:i + 3]]
    got = recipe_mix.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    monkeypatch.setattr(sys, "argv", ["recipe_mix.py"] + argv)
    jax_recipe_mix.main()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert ("effective_img_s_chip" in got) == (len(ms) == 6)
