"""The FCOS mutual step replayed as CUDA graphs (engine/step_graph.py)
against the same step run eagerly, on the card; skipped without one.

  * Over the burn-in boundary's step and two EMA steps, on a same-aspect and
    a mixed-aspect canvas pair, from the same weights, batches and
    generator: the graphed run's set-up is the benchmark's (one step on the
    pair, which runs eagerly and is captured, then the weights copied back
    in place, SGD's state cleared and the update count reset), so its three
    steps are replays. Metrics, student, teacher, momentum buffers and the
    generator's offset after each step equal the eager run's, within what
    two eager runs differ by (whose atomics may add in another order). The
    hand-written kernels' launch counters read the same over the three
    steps, and FlopCounterMode counts the same FLOPs in one more step.
  * The memory of all 16 captures of the recipe's canvas pairs, at its
    sizes: max_memory_allocated within 1% of the eager steps'.

This file imports no JAX (the card's machine has none). On the card:
    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_step_graph_card.py
"""

from __future__ import annotations

import gc
import itertools
import os
import time

import pytest
import torch

pytestmark = pytest.mark.card

CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "FCOS", "coco-standard",
                        "fcos_R_50_ut2_sup1_run0.yaml")
# the recipe as the benchmark's cell runs it; SMALL cuts the canvases and the batch
RECIPE = ["SEMISUPNET.BURN_UP_STEP", "1", "MODEL.WEIGHTS", ""]
SMALL = RECIPE + ["TPU.CANVAS_LANDSCAPE", "(256, 384)", "TPU.CANVAS_PORTRAIT", "(384, 256)",
                  "TPU.EXTRA_TRAIN_CANVASES", "()", "SOLVER.IMG_PER_BATCH_LABEL", "2",
                  "SOLVER.IMG_PER_BATCH_UNLABEL", "2", "TPU.NMS_CANDIDATES", "1000"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's graphs exist only on the card")
    return torch.device("cuda", 0)


def _cfg(opts):
    from ubteacher_tpu_torch.config import add_ubteacher_config, get_cfg

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    cfg.merge_from_file(CFG_PATH)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def _canvases(cfg):
    return [tuple(cfg.TPU.CANVAS_LANDSCAPE), tuple(cfg.TPU.CANVAS_PORTRAIT)] + [
        tuple(c) for c in cfg.TPU.EXTRA_TRAIN_CANVASES]


def _state(cfg, device):
    """The same weights on every call: the init's draws on the CPU from one
    seed, the focal prior's bias raised so that the teacher's NMS sees
    candidates."""
    from ubteacher_tpu_torch.engine import FCOSTrainState
    from ubteacher_tpu_torch.modeling.fcos_head import build_one_stage_detector
    from ubteacher_tpu_torch.solver import build_optimizer

    model = build_one_stage_detector(cfg, device, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(1.0)
    return FCOSTrainState.create(model, build_optimizer(cfg, model))


def _batch(cfg, lc, uc, gen, device):
    from ubteacher_tpu_torch.structures import PaddedInstances

    bl, bu, m = cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.IMG_PER_BATCH_UNLABEL, cfg.TPU.MAX_GT

    def images(b, c):
        return torch.randint(0, 256, (b, c[0], c[1], 3), generator=gen, device=device, dtype=torch.uint8)

    xy = torch.rand((bl, m, 2), generator=gen, device=device) * (min(lc) / 2)
    wh = 16 + torch.rand((bl, m, 2), generator=gen, device=device) * (min(lc) / 3)
    mask = torch.zeros((bl, m), dtype=torch.bool, device=device)
    mask[:, :5] = True
    gt = PaddedInstances(
        boxes=torch.cat([xy, xy + wh], -1),
        classes=torch.randint(0, cfg.MODEL.FCOS.NUM_CLASSES, (bl, m), generator=gen, device=device),
        scores=torch.ones((bl, m), device=device), box_std=torch.zeros((bl, m, 4), device=device), mask=mask)
    return {"images_label_k": images(bl, lc), "gt_label": gt,
            "label_hw": torch.tensor(lc, dtype=torch.float32, device=device).expand(bl, 2),
            "images_unlabel_k": images(bu, uc),
            "unlabel_hw": torch.tensor(uc, dtype=torch.float32, device=device).expand(bu, 2)}


def _reset(state, w0):
    """The benchmark's reset after its set-up steps."""
    with torch.no_grad():
        for model in (state.student, state.teacher):
            for p, w in zip(model.parameters(), w0):
                p.copy_(w)
    state.optimizer.sgd.state.clear()
    state.optimizer.count = 0


def _snapshot(state, metrics, rng):
    bufs = [state.optimizer.sgd.state[p]["momentum_buffer"] for p in state.optimizer.params]
    return {
        "metrics": torch.stack([metrics[k].double().reshape(()) for k in sorted(metrics)
                                if k != "ema_rate_1000x"]),
        "student": torch.cat([p.detach().reshape(-1) for p in state.student.parameters()]),
        "teacher": torch.cat([p.detach().reshape(-1) for p in state.teacher.parameters()]),
        "momentum": torch.cat([b.reshape(-1) for b in bufs]),
        "offset": torch.tensor(float(rng.get_offset())),
    }


def _run(cfg, mutual, batches, device, graphed, monkeypatch):
    """-> (a snapshot after each step, the kernels' launch counts over the
    steps, the FLOPs that FlopCounterMode counts in one more step)."""
    from ubteacher_tpu_torch.engine import fcos_trainer
    from ubteacher_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ubteacher_tpu_torch.tools.mfu import count_step_flops
    from ubteacher_tpu_torch.utils.events import span_totals

    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(fcos_trainer, "_graphable", lambda batch: False)
        state = _state(cfg, device)
        burn_up = cfg.SEMISUPNET.BURN_UP_STEP
        w0 = [p.detach().clone() for p in state.student.parameters()]
        if graphed:
            state.step = burn_up
            mutual(state, dict(batches[0], rng=torch.Generator(device).manual_seed(99)))
            _reset(state, w0)
        state.step = burn_up
        rng = torch.Generator(device).manual_seed(17)
        replays0 = span_totals().get("ubt.step.graph_replay", (0,))[0]
        reset_launch_counts()
        out = []
        for b in batches:
            state, metrics = mutual(state, dict(b, rng=rng))
            out.append(_snapshot(state, metrics, rng))
        torch.cuda.synchronize()
        counts = launch_counts()
        replays = span_totals().get("ubt.step.graph_replay", (0,))[0] - replays0
        flops, state, _ = count_step_flops(mutual, state, dict(batches[0], rng=rng))
        # under FlopCounterMode the step runs eagerly: no replay
        assert span_totals().get("ubt.step.graph_replay", (0,))[0] - replays0 == replays
    assert replays == (len(batches) if graphed else 0)
    return out, counts, flops


def _gap(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("pair", ["same_aspect", "mixed_aspect"])
def test_replays_equal_the_eager_steps(card, pair, monkeypatch):
    from ubteacher_tpu_torch.engine import make_fcos_train_steps

    cfg = _cfg(SMALL)
    lc = tuple(cfg.TPU.CANVAS_LANDSCAPE)
    uc = lc if pair == "same_aspect" else tuple(cfg.TPU.CANVAS_PORTRAIT)
    gen = torch.Generator(card).manual_seed(5)
    batches = [_batch(cfg, lc, uc, gen, card) for _ in range(3)]
    _, mutual = make_fcos_train_steps(cfg)
    eager, counts, flops = _run(cfg, mutual, batches, card, False, monkeypatch)
    again, _, _ = _run(cfg, mutual, batches, card, False, monkeypatch)
    graphed, graphed_counts, graphed_flops = _run(cfg, mutual, batches, card, True, monkeypatch)
    print(f"{pair}: launches eager {counts}, graphed {graphed_counts}; FLOPs eager {flops}, graphed {graphed_flops}")
    assert graphed_counts == counts and counts["nms"] == 2 * len(batches) and counts["focal_fwd"] > 0
    assert graphed_flops == flops > 0
    for i, (e, a, g) in enumerate(zip(eager, again, graphed)):
        for k in e:
            floor, gap = _gap(a[k], e[k]), _gap(g[k], e[k])
            print(f"{pair} step {i} {k}: graphed - eager {gap:.3g}, eager - eager {floor:.3g}, "
                  f"bitwise {torch.equal(g[k], e[k])}")
            if k == "offset" or floor == 0.0:
                assert torch.equal(g[k], e[k]), (pair, i, k, gap)
            else:
                assert gap <= 4 * floor, (pair, i, k, gap, floor)


def test_sixteen_captures_hold_the_eager_steps_memory(card, monkeypatch):
    from ubteacher_tpu_torch.engine import fcos_trainer, make_fcos_train_steps

    cfg = _cfg(RECIPE)
    pairs = list(itertools.product(_canvases(cfg), repeat=2))
    assert len(pairs) == 16
    _, mutual = make_fcos_train_steps(cfg)
    gen = torch.Generator(card).manual_seed(7)
    peaks, seconds = {}, {}
    for graphed in (False, True):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(fcos_trainer, "_graphable", lambda batch: False)
            state = _state(cfg, card)
            state.step = cfg.SEMISUPNET.BURN_UP_STEP
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(card)
            t0 = time.perf_counter()
            for lc, uc in pairs:  # the first use of each pair: eager, then captured
                state, metrics = mutual(state, dict(_batch(cfg, lc, uc, gen, card), rng=gen))
                float(metrics["total_loss"])
            seconds[graphed] = time.perf_counter() - t0
            for lc, uc in pairs:  # every later use: a replay
                state, metrics = mutual(state, dict(_batch(cfg, lc, uc, gen, card), rng=gen))
            float(metrics["total_loss"])
            peaks[graphed] = torch.cuda.max_memory_allocated(card)
            if graphed:
                assert len(state.graphs.graphs) == 16
            del state, metrics
            gc.collect()
            torch.cuda.empty_cache()
    print(f"max_memory_allocated: eager {peaks[False]} B, graphed {peaks[True]} B "
          f"({100 * (peaks[True] / peaks[False] - 1):+.3f}%); 16 first steps {seconds[False]:.2f} s eager, "
          f"{seconds[True]:.2f} s with the captures")
    assert peaks[True] <= 1.01 * peaks[False]
