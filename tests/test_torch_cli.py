"""The port's CLI (python -m ubteacher_tpu_torch.train_net), after
tests/test_cli.py: the disk COCO layout under $COCO_ROOT, the dataseed split
file, KEY VALUE overrides, training then --eval-only --resume, and
--eval-only MODEL.WEIGHTS x.pth of a reference-format EnsembleTSModel
checkpoint; MODEL.DEVICE cpu selects the CPU, anything else the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_cli import _write_coco_root
from test_full_checkpoint_convert import _synthetic_reference_state
from torch_parity import TEST_TORCH_THREADS, few_torch_threads  # noqa: F401 (an autouse fixture)
from ubteacher_tpu.checkpoint.torch_weights import convert_ubt_fcos_model as jax_convert
from ubteacher_tpu_torch import train_net
from ubteacher_tpu_torch.checkpoint import params_from_jax
from ubteacher_tpu_torch.data.coco import generate_supervision_seed_file

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = "configs/FCOS/coco-standard/fcos_R_50_ut2_sup1_run0.yaml"


def _opts(tmp_path, out_dir, weights=""):
    return [
        "MODEL.DEVICE", "cpu",
        "MODEL.RESNETS.DEPTH", "18",
        "MODEL.FCOS.NUM_CLASSES", "1",
        "TPU.COMPUTE_DTYPE", "float32",
        "TPU.CANVAS_LANDSCAPE", "(64, 64)",
        "TPU.CANVAS_PORTRAIT", "(64, 64)",
        "TPU.TEST_CANVAS", "(64, 64)",
        "TPU.MAX_GT", "8",
        "TPU.MAX_PSEUDO", "20",
        "TPU.NMS_CANDIDATES", "100",
        "TPU.DATA_THREADS", "2",
        "INPUT.MIN_SIZE_TRAIN", "(48,)",
        "INPUT.MIN_SIZE_TRAIN_SAMPLING", "choice",
        "INPUT.MAX_SIZE_TRAIN", "64",
        "INPUT.MIN_SIZE_TEST", "48",
        "INPUT.MAX_SIZE_TEST", "64",
        "SOLVER.IMG_PER_BATCH_LABEL", "2",
        "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
        "SOLVER.MAX_ITER", "2",
        "SOLVER.BASE_LR", "0.001",
        "SEMISUPNET.BURN_UP_STEP", "1",
        "TEST.EVAL_PERIOD", "2",
        "DATALOADER.SUP_PERCENT", "50.0",
        "DATALOADER.RANDOM_DATA_SEED", "0",
        "DATALOADER.RANDOM_DATA_SEED_PATH", str(tmp_path / "seed.txt"),
        "MODEL.WEIGHTS", weights,
        "OUTPUT_DIR", str(out_dir),
    ]


@pytest.fixture
def coco_root(tmp_path, monkeypatch):
    root = tmp_path / "coco"
    _write_coco_root(root, size=48)
    generate_supervision_seed_file(str(tmp_path / "seed.txt"), num_images=8, percents=(50.0,), seeds=1)
    monkeypatch.setenv("COCO_ROOT", str(root))
    return root


def test_cli_trains_then_evaluates_the_checkpoint(tmp_path, coco_root):
    out_dir = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT), OMP_NUM_THREADS=str(TEST_TORCH_THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "ubteacher_tpu_torch.train_net", "--config", CONFIG] + _opts(tmp_path, out_dir),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert (out_dir / "log.txt").exists()
    assert sorted(os.listdir(out_dir / "checkpoints")) == ["2"]
    lines = (out_dir / "metrics.json").read_text().splitlines()
    assert any('"teacher/AP"' in line for line in lines)  # the eval at TEST.EVAL_PERIOD

    # --eval-only --resume evaluates the teacher of the newest checkpoint
    parser = train_net.default_argument_parser()
    args = parser.parse_args(["--config", CONFIG, "--eval-only", "--resume"] + _opts(tmp_path, out_dir))
    results = train_net.main(args)
    assert {"AP", "AP50", "AP75"} <= set(results) and np.isfinite(results["AP"])


def test_eval_only_loads_a_reference_checkpoint(tmp_path, coco_root, caplog):
    """--eval-only MODEL.WEIGHTS x.pth fills the teacher and the student of
    an EnsembleTSModel checkpoint (DDP 'module.' prefix on the student)
    through the reference-weight converters, as JAX's converter followed by
    params_from_jax gives them, and reports the keys nothing took."""
    rng = np.random.default_rng(3)
    sd_t = _synthetic_reference_state(18, 1, 4 * 17, rng)
    sd_s = _synthetic_reference_state(18, 1, 4 * 17, rng)
    ensemble = {f"modelTeacher.{k}": torch.from_numpy(v) for k, v in sd_t.items()}
    ensemble.update({f"modelStudent.module.{k}": torch.from_numpy(v) for k, v in sd_s.items()})
    ensemble["modelTeacher.proposal_generator.fcos_head.unused.weight"] = torch.zeros(2)
    ckpt = tmp_path / "ensemble.pth"
    torch.save({"model": ensemble, "iteration": 1234}, str(ckpt))

    args = train_net.default_argument_parser().parse_args(
        ["--config", CONFIG, "--eval-only"] + _opts(tmp_path, tmp_path / "out", str(ckpt)))
    cfg = train_net.setup(args)
    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

    trainer = UBTeacherTrainer(cfg, device=train_net.device_of(cfg))
    with caplog.at_level("WARNING", logger="ubteacher_tpu_torch"):
        trainer.resume_or_load(resume=False)
    assert "proposal_generator.fcos_head.unused.weight" in caplog.text
    for module, sd in ((trainer.state.teacher, sd_t), (trainer.state.student, sd_s)):
        got = module.state_dict()
        for k, v in params_from_jax(jax_convert(sd, depth=18)).items():
            assert torch.equal(got[k], v), k
    assert not torch.equal(trainer.state.teacher.head.cls_logits.weight, trainer.state.student.head.cls_logits.weight)
    results = trainer.test(model="teacher")
    assert "AP" in results


def test_vis_period_writes_panels(tmp_path, coco_root):
    """VIS_PERIOD: labeled (gt | student pred) panels, and in the mutual
    phase unlabeled (pseudo-cls | pseudo-reg | student pred) ones."""
    import cv2

    out_dir = tmp_path / "out"
    args = train_net.default_argument_parser().parse_args(
        ["--config", CONFIG] + _opts(tmp_path, out_dir) + ["VIS_PERIOD", "1", "TEST.EVAL_PERIOD", "0"])
    train_net.main(args)
    vis = out_dir / "vis"
    labeled, unlabeled = sorted(vis.glob("*_labeled.png")), sorted(vis.glob("*_unlabeled.png"))
    assert len(labeled) == 2 and len(unlabeled) == 1  # iteration 2 is mutual
    assert cv2.imread(str(labeled[0])).shape == (64, 2 * 64, 3)
    assert cv2.imread(str(unlabeled[0])).shape == (64, 3 * 64, 3)


def test_device_and_process_rules(tmp_path, monkeypatch):
    parser = train_net.default_argument_parser()
    with pytest.raises(NotImplementedError):
        train_net.setup(parser.parse_args(["--config", CONFIG, "--num-gpus", "2"]))
    with pytest.raises(NotImplementedError):
        train_net.setup(parser.parse_args(["--config", CONFIG, "--num-machines", "2"]))
    cfg = train_net.setup(parser.parse_args(["--config", CONFIG]))
    assert cfg.MODEL.DEVICE == "tpu" and train_net.device_of(cfg) == "cuda:0"  # the shared default: the card
    assert train_net.device_of(train_net.setup(parser.parse_args(["--config", CONFIG, "MODEL.DEVICE", "cpu"]))) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(parser.parse_args(["--config", CONFIG, "OUTPUT_DIR", str(tmp_path / "out")]))
