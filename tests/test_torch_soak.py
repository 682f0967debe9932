"""The port's soak (ubteacher_tpu_torch/tools/soak.py): its state hash,
and a tiny kill -9 and resume on the CPU.

state_hash must not depend on the order of a dict's keys, and must change
when any element of any tensor, the step or an optimizer field changes.
The tiny soak is the recipe cut to R-18 at 96x128 / 128x96 canvases with a
128x128 bucket, 2 + 2 images, on the tool's 200 JPEGs: the child process trains
(burn-in 2), is killed with SIGKILL once the checkpoint at 2 is in place,
and the resumed run must hash bitwise to what the child recorded at that
save, then reach MAX_ITER 5. The child gets its own time limit, counted
from its start (--timeout), and two intra-op threads."""

import copy

import pytest
import torch

from torch_parity import (  # noqa: F401 (fixtures: autouse, or named in usefixtures)
    few_torch_threads,
    large_files_removed,
    tmp_budget,
)
from ubteacher_tpu_torch.tools import soak

TINY = [
    "--cpu", "--max-iter", "5", "--kill-at", "2", "--burnin", "2", "--checkpoint-period", "2",
    "--eval-period", "0", "--rss-period", "0.5", "--timeout", "240",
    "--opts", "MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32",
    "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
    "TPU.CANVAS_LANDSCAPE", "(96, 128)", "TPU.CANVAS_PORTRAIT", "(128, 96)",
    "TPU.EXTRA_TRAIN_CANVASES", "[[128, 128]]", "TPU.TEST_CANVAS", "(128, 128)",
    "INPUT.MIN_SIZE_TRAIN", "(64, 128)", "INPUT.MAX_SIZE_TRAIN", "128",
    "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128",
    "TPU.MAX_GT", "8", "TPU.MAX_PSEUDO", "20", "TPU.NMS_CANDIDATES", "100", "TPU.DATA_THREADS", "2",
]


def _state():
    g = torch.Generator().manual_seed(0)
    return {
        "student": {"a.weight": torch.randn(3, 4, generator=g), "b.scale": torch.randn(5, generator=g).bfloat16()},
        "teacher": {"a.weight": torch.randn(3, 4, generator=g), "b.scale": torch.zeros(5).bfloat16()},
        "optimizer": {"sgd": {"state": {0: {"momentum_buffer": torch.randn(3, 4, generator=g)}},
                              "param_groups": [{"lr": 0.01, "params": [0, 1]}]}, "count": 3},
        "step": 7,
        "generator": torch.Generator().manual_seed(1).get_state(),
    }


def test_state_hash_is_stable_and_sensitive():
    s = _state()
    h = soak.state_hash(s)
    assert soak.state_hash(copy.deepcopy(s)) == h
    reordered = dict(reversed(list(s.items())))
    reordered["student"] = dict(reversed(list(s["student"].items())))
    assert soak.state_hash(reordered) == h

    def changed(edit):
        t = copy.deepcopy(s)
        edit(t)
        return soak.state_hash(t)

    edits = [
        lambda t: t["student"]["a.weight"].view(-1)[5].add_(1e-6),
        lambda t: t["student"]["b.scale"].view(-1)[4].add_(1.0),
        lambda t: t["teacher"]["b.scale"].view(-1)[0].neg_(),  # -0.0: other bits, equal value
        lambda t: t["optimizer"]["sgd"]["state"][0]["momentum_buffer"].view(-1)[0].mul_(2.0),
        lambda t: t["optimizer"]["sgd"]["param_groups"][0].update(lr=0.02),
        lambda t: t["optimizer"].update(count=4),
        lambda t: t.update(step=8),
        lambda t: t.update(generator=torch.Generator().manual_seed(2).get_state()),
        lambda t: t["student"].update({"a.weight": t["student"]["a.weight"].reshape(4, 3)}),
    ]
    hashes = [changed(e) for e in edits]
    assert h not in hashes and len(set(hashes)) == len(hashes)


@pytest.mark.usefixtures("large_files_removed")
def test_kill_and_resume_tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    summary = soak.main(TINY + ["--workdir", str(tmp_path)])
    assert summary["resume_hash_bitwise_equal"] is True
    assert summary["resumed_at"] == 2 and summary["reached_max_iter"] and summary["max_iter"] == 5
    assert summary["checkpoints"][-1] == 5 and 2 in summary["checkpoints"]
    assert summary["final_losses_finite"]
    assert summary["first_use"] and {r["process"] for r in summary["first_use"]} == {"child", "resumed"}
    assert summary["iterations"] >= 5 and summary["rss_max_mb"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the device rule without a card")
def test_child_needs_the_card_or_cpu(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA device"):
        soak.main(["--child", "--workdir", str(tmp_path)])
