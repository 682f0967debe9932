"""A run with the timed path broken underneath comes out not correct: the
harness driven at a small size on the CPU (its look for a chip skipped),
once for each fault a one-chip train cell can have: the student's state
left unchanged, the EMA teacher's state left unchanged, half of each batch
left out, an image altered where it is produced. (The exchange between
chips is absent on one chip.)"""

import pytest
import torch

import ubteacher_tpu_torch.engine.fcos_trainer as fcos_trainer
from benchmark.harness import train_cell
from benchmark.tests import small


def _no_update(state, total):
    """The step's backward runs, the optimizer does not: state unchanged."""
    state.optimizer.zero_grad()
    total.backward()
    state.step += 1


def _no_ema(teacher, student, keep_rate):
    """Neither the boundary's copy nor the EMA reaches the teacher."""


def _half_batch(step):
    """Half of each stream's rows dropped before the step; the step's
    means are then over the rest."""
    def wrapped(state, batch):
        out = dict(batch)
        for k in ("images_label_k", "label_hw", "images_unlabel_k", "unlabel_hw"):
            out[k] = batch[k][: batch[k].shape[0] // 2]
        out["gt_label"] = batch["gt_label"].map(lambda x: x[: x.shape[0] // 2])
        return step(state, out)
    return wrapped


def _altered_image(step):
    """The loader's first labeled image replaced where it is produced."""
    def wrapped(state, batch):
        out = dict(batch)
        images = batch["images_label_k"].clone()
        images[0] = 255 - images[0]
        out["images_label_k"] = images
        return step(state, out)
    return wrapped


@pytest.mark.parametrize("fault", ["state_unchanged", "teacher_unchanged", "half_batch", "altered_answer"])
def test_broken_step_is_not_correct(fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(fcos_trainer, "sgd_step", _no_update)
    elif fault == "teacher_unchanged":
        monkeypatch.setattr(fcos_trainer, "_ema_update", _no_ema)
    else:
        wrap = _half_batch if fault == "half_batch" else _altered_image
        build = train_cell.TrainCell.build

        def broken_build(self):
            build(self)
            self.trainer.burnin_step = wrap(self.trainer.burnin_step)
            self.trainer.mutual_step = wrap(self.trainer.mutual_step)

        monkeypatch.setattr(train_cell.TrainCell, "build", broken_build)
    result, lines = small.run(seed=5)
    assert not result["correct"], lines
    if fault == "teacher_unchanged":
        assert result["checks"]["teacher_gap"]["value"] > result["checks"]["teacher_gap"]["limit"], lines


def test_the_run_needs_the_cards_the_cell_asks_for(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fcos_mutual_recipe", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err

