"""Data parallelism of the port's train steps and trainer: two gloo CPU
processes (ubteacher_tpu_torch.parallel.launch), each with half of the
global batch, against one process with all of it, and through that one
process against the JAX step on the same global batch.

Setups: the small FCOS configuration of test_torch_fcos_trainer.py at a
global batch of 4 (2 rows a rank) whose labeled rows hold 2 gt boxes on
rank 0 and 1 on rank 1, so the ranks' positive counts differ (a normalizer
left local would fail); the small Faster R-CNN setup of test_torch_rcnn.py
(2 rows, image 0 with 2 gt boxes and image 1 with 3), oracle pseudo labels.
Each runs one burn-in step and one mutual step from the same parameters,
with the JAX package's draws for the global batch injected, and one mutual
step whose draws each rank takes from the same seeded generator.

Tolerances, and why:
  * ranks vs one process: every count (num_*) and ema_rate_1000x equal; the
    losses (sums of per-rank shares) within 1e-5 relative + 1e-7, float32
    sums in another order (measured: 2e-7); parameter updates (new -
    initial) within 1e-2 of the update's norm per tensor and 2e-3 over the
    model (measured: up to 2.2e-3 and 6.4e-4, in tensors whose gradients are
    sums of strongly cancelling terms, as test_torch_fcos_trainer.py notes);
    the two ranks' parameters bitwise equal (one summed gradient);
  * one process vs JAX: the tolerances of test_torch_fcos_trainer.py and
    test_torch_rcnn.py, whose reasons are given there;
  * the trainer: the same rules per iteration over a 4-iteration run, and
    the eval's AP fields equal across ranks and within 1e-6 of one
    process's.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as W
from test_torch_fcos_trainer import CLS_BIAS, RNG_KEY, SEED, _compare_metrics, _compare_params, _jax_step
from torch_parity import (  # noqa: F401 (fixtures: autouse, or named in usefixtures)
    CANVAS,
    CFG_PATH,
    RCNN_B,
    RCNN_CANVAS,
    RCNN_CFG_PATH,
    RCNN_NUM_ANCHORS,
    RCNN_SMALL_OPTS,
    SMALL_OPTS,
    SPAN_SCALARS,
    TRAINER_OPTS,
    canvas_opts,
    compare_rcnn_metrics,
    compare_rcnn_updates,
    few_torch_threads,
    hold_jax_rcnn_step,
    jax_instances,
    jax_model_and_params,
    jax_rcnn_step,
    jax_sampling_draws,
    jax_strong_draws,
    large_files_removed,
    port_instances,
    rcnn_setup,
    remove_large_files,
    remove_large_files_at_teardown,
    small_cfgs,
    synthetic_batch,
    synthetic_coco,
    tmp_budget,
    trainer_datasets,
)
from ubteacher_tpu_torch.checkpoint import params_from_jax

B = 4
WORLD = 2
RCNN_OPTS = ("TPU.ORACLE_PSEUDO", "True")
GEN_SEED = 9


def _fcos_inputs():
    """JAX setup and the port case of the FCOS steps."""
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_model_and_params(jcfg, seed=SEED, cls_bias=np.full(4, CLS_BIAS))
    images_l, boxes, classes, mask = synthetic_batch(SEED + 100, B, 4, jcfg.TPU.MAX_GT)
    mask[B // 2:, 1] = False  # rank 1's labeled rows: one box each
    images_u, _, _, _ = synthetic_batch(SEED + 200, B, 4, jcfg.TPU.MAX_GT)
    key = jax.random.PRNGKey(RNG_KEY)
    jbatch = {"images_label_k": jax.numpy.asarray(images_l), "gt_label": jax_instances(boxes, classes, mask),
              "images_unlabel_k": jax.numpy.asarray(images_u), "rng": key}
    h, w = CANVAS
    k_label, k_unlabel = jax.random.split(key)
    burn_up = tcfg.SEMISUPNET.BURN_UP_STEP
    case = {
        "kind": "fcos", "opts": SMALL_OPTS, "cfg_path": CFG_PATH, "params": params_from_jax(params),
        "batch": {"images_label_k": torch.from_numpy(images_l), "gt_label": port_instances(boxes, classes, mask),
                  "images_unlabel_k": torch.from_numpy(images_u)},
        "steps": [
            ("burnin", 0, {"strong_label": jax_strong_draws(key, B, h, w)}),
            ("mutual", burn_up, {"strong_label": jax_strong_draws(k_label, B, h, w),
                                 "strong_unlabel": jax_strong_draws(k_unlabel, B, h, w)}),
            ("mutual", burn_up, {"rng_seed": GEN_SEED}),
        ],
    }
    return (jcfg, jmodel, params, jbatch), case


def _rcnn_inputs():
    """JAX setup and the port case of the R-CNN steps (fused canvases)."""
    jcfg, tcfg, jmodel, params, jbatch, tbatch = rcnn_setup(RCNN_CANVAS, RCNN_OPTS)
    b = RCNN_B
    post, m_gt, m_ps = jcfg.MODEL.RPN.POST_NMS_TOPK_TRAIN, jcfg.TPU.MAX_GT, jcfg.TPU.MAX_PSEUDO
    anchors = RCNN_NUM_ANCHORS[RCNN_CANVAS]
    _, k_branch = jax.random.split(jbatch["rng"])
    _, _, k_sup, _ = jax.random.split(jbatch["rng"], 4)
    strong = {k: tbatch.pop(k) for k in ("strong_label", "strong_unlabel")}
    burn_up = tcfg.SEMISUPNET.BURN_UP_STEP
    case = {
        "kind": "rcnn", "opts": RCNN_SMALL_OPTS + list(RCNN_OPTS), "cfg_path": RCNN_CFG_PATH,
        "params": params_from_jax(params), "batch": tbatch,
        "steps": [
            ("burnin", 0, dict(strong, sampling_sup=jax_sampling_draws(k_branch, 2 * b, anchors, post + m_gt))),
            ("mutual", burn_up, dict(strong, sampling_sup=jax_sampling_draws(k_sup, 3 * b, anchors,
                                                                             post + max(m_gt, m_ps)))),
            ("mutual", burn_up, {"rng_seed": GEN_SEED}),
        ],
    }
    return (jcfg, jmodel, params, jbatch), case


@pytest.fixture(scope="module")
def setup(tmp_path_factory, request):
    """Both setups, and their cases started on two ranks (they run while the
    one-process steps run here). The inputs and rank files are deleted when
    the module ends, whatever its outcome."""
    d = tmp_path_factory.mktemp("dp_steps")
    remove_large_files_at_teardown(request, d)
    jax_fcos, fcos = _fcos_inputs()
    jax_rcnn, rcnn = _rcnn_inputs()
    cases = {"fcos": fcos, "rcnn": rcnn}
    torch.save(cases, str(d / "inputs.pt"))
    ranks = W.start_ranks("dp_steps", WORLD, str(d / "inputs.pt"), str(d))
    try:
        yield {"cases": cases, "jax": {"fcos": jax_fcos, "rcnn": jax_rcnn}, "ranks": ranks, "dir": d}
    finally:
        if ranks.proc.poll() is None:
            os.killpg(ranks.proc.pid, 9)


@pytest.fixture(scope="module")
def one_process(setup):
    """The steps in this process, beside the ranks; the ranks are joined
    before it returns, so that the JAX steps that follow here do not spend
    the ranks' time limit."""
    out = {name: W.run_steps(case) for name, case in setup["cases"].items()}
    setup["ranks"].join()
    return out


@pytest.fixture(scope="module")
def ranked(setup):
    """The ranks' results, in memory (the inputs and rank files are deleted
    once read), with the tensors a rank left at the case's initial value
    (torch_dp_worker.dp_steps writes None for them) put back."""
    setup["ranks"].wait()
    d = setup["dir"]
    files = [torch.load(str(d / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    remove_large_files(d)
    for got in files:
        for name, case in setup["cases"].items():
            for step in got[name]:
                for part in ("student", "teacher"):
                    step[part] = {k: case["params"][k] if v is None else v for k, v in step[part].items()}
    return files


def test_fcos_one_process_matches_jax(setup, one_process):
    jcfg, jmodel, params, jbatch = setup["jax"]["fcos"]
    burnin, mutual, _ = one_process["fcos"]
    j_student, _, j_metrics = _jax_step(jcfg, jmodel, params, jbatch, "burnin", 0)
    _compare_metrics(burnin["metrics"], j_metrics, rtol=2e-3)
    _compare_params(_module(burnin["student"]), j_student, params, "burnin student")
    j_student, _, j_metrics = _jax_step(jcfg, jmodel, params, jbatch, "mutual", jcfg.SEMISUPNET.BURN_UP_STEP)
    assert j_metrics["num_pseudo_cls"] > 0 and j_metrics["num_pseudo_reg"] > 0
    for k in ("num_pseudo_cls", "num_pseudo_reg", "ema_rate_1000x"):
        assert mutual["metrics"][k] == j_metrics[k], k
    _compare_metrics(mutual["metrics"], j_metrics, rtol=2e-3)
    _compare_params(_module(mutual["student"]), j_student, params, "mutual student")


def test_rcnn_one_process_matches_jax(setup, one_process, monkeypatch):
    hold_jax_rcnn_step(monkeypatch)
    jcfg, jmodel, params, jbatch = setup["jax"]["rcnn"]
    burnin, mutual, _ = one_process["rcnn"]
    j_student, _, j_metrics = jax_rcnn_step(jcfg, jmodel, params, jbatch, "burnin", 0)
    assert burnin["metrics"]["num_rpn_samples"] == 2 * RCNN_B * 64
    compare_rcnn_metrics(burnin["metrics"], j_metrics)
    compare_rcnn_updates(_module(burnin["student"]), j_student, params, "burnin student")
    j_student, _, j_metrics = jax_rcnn_step(jcfg, jmodel, params, jbatch, "mutual", jcfg.SEMISUPNET.BURN_UP_STEP)
    for k in ("num_pseudo", "ema_rate_1000x"):
        assert mutual["metrics"][k] == j_metrics[k], k
    compare_rcnn_metrics(mutual["metrics"], j_metrics)
    compare_rcnn_updates(_module(mutual["student"]), j_student, params, "mutual student")


class _module:
    """A state_dict seen as a module (for the JAX comparisons' helpers)."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def _assert_metrics_close(got, ref, what):
    assert set(got) == set(ref), what
    for k, v in ref.items():
        if k.startswith("num_") or k == "ema_rate_1000x":
            assert got[k] == v, f"{what} {k}: {got[k]} != {v}"
        else:
            assert abs(got[k] - v) <= 1e-5 * abs(v) + 1e-7, f"{what} {k}: {got[k]} vs {v}"


def _assert_updates_close(got, ref, init, what):
    """Updates (new - initial) of every tensor within 1e-2 of the reference
    update's norm, 2e-3 over the model; untouched tensors untouched."""
    num = den = 0.0
    for name, r in ref.items():
        dr = r.double() - init[name].double()
        dg = got[name].double() - init[name].double()
        if not dr.any():
            assert not dg.any(), f"{what} {name} moved"
            continue
        err = float((dg - dr).norm() / dr.norm())
        assert err < 1e-2, f"{what} {name}: {err}"
        num += float((dg - dr).norm() ** 2)
        den += float(dr.norm() ** 2)
    assert den > 0 and (num / den) ** 0.5 < 2e-3, f"{what}: {(num / den) ** 0.5}"


@pytest.mark.parametrize("name", ["fcos", "rcnn"])
def test_ranks_match_one_process(setup, one_process, ranked, name, request):
    """Each step on two ranks: the global metrics (summed over the ranks)
    and the updates are one process's on the global batch. The ranks'
    timing goes into the junit report (seconds from the launch to each
    rank's start and to the join, and each rank's cases), to place a run
    that misses RANKS_TIMEOUT."""
    ranks = setup["ranks"]
    request.node.user_properties.append(("ranks_seconds", {
        "launch_to_join": round(ranks.ended - ranks.started, 1),
        "rank_start": [round(f["seconds"]["started_at"] - ranks.started, 1) for f in ranked],
        "rank_cases": [{k: round(v, 1) for k, v in f["seconds"].items() if k != "started_at"} for f in ranked],
    }))
    init = setup["cases"][name]["params"]
    for i, ref in enumerate(one_process[name]):
        what = f"{name} step {i}"
        for r in range(WORLD):
            got = ranked[r][name][i]
            _assert_metrics_close(got["metrics"], ref["metrics"], f"{what} rank {r}")
            _assert_updates_close(got["student"], ref["student"], init, f"{what} rank {r}")
    if name == "fcos":  # the ranks' positive counts differ and every branch ran
        assert one_process[name][1]["metrics"]["num_pseudo_cls"] > 0


@pytest.mark.parametrize("name", ["fcos", "rcnn"])
def test_ranks_hold_bitwise_equal_parameters(ranked, name):
    """Both ranks apply one summed gradient: student and teacher equal bit
    for bit after every step."""
    for i, step0 in enumerate(ranked[0][name]):
        for part in ("student", "teacher"):
            for k, v in step0[part].items():
                assert torch.equal(v, ranked[1][name][i][part][k]), f"{name} step {i} {part} {k}"


@pytest.mark.usefixtures("large_files_removed")
def test_trainer_on_two_ranks_matches_one_process(tmp_path):
    """UBTeacherTrainer on two ranks (each loading its rows of the 2 + 2
    global batch) against one process: per-iteration global metrics and
    the parameters as above, one checkpoint written (by rank 0), a resume
    on both ranks holding the saved state bitwise, and the teacher's eval
    (the test set split by rank, the detection rows gathered) the same on
    both ranks and within 1e-6 of one process's."""
    dicts, image_loader = synthetic_coco(size=48)
    images = {d["file_name"]: image_loader(d["file_name"]) for d in dicts}
    data = str(tmp_path / "data.pt")
    torch.save({"datasets": trainer_datasets(dicts), "images": images}, data)

    def opts(sub):
        return (TRAINER_OPTS + ["MODEL.FCOS.NUM_CLASSES", "3"] + canvas_opts(64, 48)
                + ["MODEL.FCOS.INFERENCE_TH_TEST", "0.0", "OUTPUT_DIR", str(tmp_path / sub)])

    ranks = W.start_ranks("dp_trainer", WORLD, data, CFG_PATH, opts("ranks"), str(tmp_path))
    try:
        ref = W.run_trainer(data, CFG_PATH, opts("one"))
    finally:
        ranks.wait()
    got = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    uncompared = {"time", "data_time", "corrupt_rows_total", *SPAN_SCALARS}
    assert len(ref["scalars"]) == 4
    assert ref["resume_differs"] == []
    for r, g in enumerate(got):
        assert g["checkpoints"] == ref["checkpoints"] == [4]
        assert g["resume_differs"] == [], f"rank {r}: the resumed state differs in {g['resume_differs'][:8]}"
        for it, (a, b) in enumerate(zip(g["scalars"], ref["scalars"])):
            _assert_metrics_close({k: v for k, v in a.items() if k not in uncompared},
                                  {k: v for k, v in b.items() if k not in uncompared}, f"iteration {it} rank {r}")
            assert all(np.isfinite(v) for v in a.values())
        for part in ("student", "teacher"):
            _assert_updates_close(g[part], ref[part], ref["init"][part], f"trainer rank {r} {part}")
            for k, v in g[part].items():
                assert torch.equal(v, got[0][part][k]), f"rank {r} {part} {k}"
    keys = sorted(k for k in ref["eval"] if k != "inference_sec_per_image")
    fields = [np.array([e["eval"][k] for k in keys]) for e in got + [ref]]
    np.testing.assert_array_equal(fields[0], fields[1], err_msg=str(keys))  # NaN where no gt of a size
    np.testing.assert_allclose(fields[0], fields[2], rtol=0, atol=1e-6, err_msg=str(keys))
    assert np.isfinite(ref["eval"]["AP"])
