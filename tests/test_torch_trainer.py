"""The port's training run (engine/trainer.py) against ubteacher_tpu's, FCOS:
4 iterations of UBTeacherTrainer.train() in each package (burn-in 2, then
mutual) on one synthetic COCO set, from the same weights (the JAX trainer's
initial parameters carried into the port by params_from_jax), with the
port's steps fed the strong-augmentation draws that the JAX trainer's keys
make (PRNGKey(SEED + 17), split once per batch; tests/torch_parity.py
replays them). The loaders are byte-equal (test_torch_train_loader.py), so
each iteration's metrics.json line must agree.

Tolerances are those of test_torch_fcos_trainer.py: the JAX strong
augmentation runs in bfloat16 and the port's in float32, so losses agree to
rtol 2e-3 (atol 1e-5); pseudo-box counts and the EMA rate are equal. The run
is well-conditioned for them: the port against itself at 1 and 8 intra-op
threads differs by at most 1.1e-5 relative in any loss, counts equal. The
head's cls_logits bias is raised to 0.5, as in that test, so that the
teacher's pseudo labels are not empty.

Also here: checkpoint and resume (bitwise), auto_scale_workers,
verify_results, the profiler hook and the device rule.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (fixtures: autouse, or named in usefixtures)
    SPAN_SCALARS,
    JaxKeyDraws,
    canvas_opts,
    few_torch_threads,
    jax_strong_draws,
    large_files_removed,
    read_metrics,
    remove_large_files_at_teardown,
    synthetic_coco,
    trainer_cfgs,
    tmp_budget,
    trainer_datasets,
)

CLS_BIAS = 0.5
# the runs that are not compared with JAX: 48-pixel images on 64x64 canvases
SMALL = canvas_opts(64, 48)
# wall-clock and process-wide counters: not compared
UNCOMPARED = {"time", "data_time", "sec_per_iter", "corrupt_rows_total", "iteration", *SPAN_SCALARS}
EXACT = ("num_pseudo_cls", "num_pseudo_reg", "ema_rate_1000x")


def _fcos_draws(burn_up):
    def draws(i, key, batch):
        b, h, w = batch["images_label_k"].shape[:3]
        if i < burn_up:
            return {"strong_label": jax_strong_draws(key, b, h, w)}
        k_label, k_unlabel = jax.random.split(key)
        bu, hu, wu = batch["images_unlabel_k"].shape[:3]
        return {"strong_label": jax_strong_draws(k_label, b, h, w),
                "strong_unlabel": jax_strong_draws(k_unlabel, bu, hu, wu)}

    return draws


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """Both packages' 4-iteration runs -> (JAX metrics lines, port metrics
    lines, port trainer)."""
    from ubteacher_tpu.engine.trainer import UBTeacherTrainer as JaxTrainer
    from ubteacher_tpu.parallel import replicate
    from ubteacher_tpu_torch.checkpoint import params_from_jax
    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

    out = tmp_path_factory.mktemp("fcos_runs")
    remove_large_files_at_teardown(request, out)
    jcfg, tcfg = trainer_cfgs(out)
    dicts, image_loader = synthetic_coco()
    datasets = trainer_datasets(dicts)

    jt = JaxTrainer(jcfg, datasets=datasets, image_loader=image_loader)
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.student))
    params["head"]["cls_logits"]["bias"] = np.full_like(params["head"]["cls_logits"]["bias"], CLS_BIAS)
    on_mesh = jax.device_put(params, replicate(jt.mesh))
    jt.state = jt.state.replace(student=on_mesh, teacher=jax.tree.map(lambda x: x.copy(), on_mesh))
    jt.storage.log_period = 1
    jt.train()

    tt = UBTeacherTrainer(tcfg, datasets=datasets, image_loader=image_loader, device="cpu")
    for module in (tt.state.student, tt.state.teacher):
        module.load_state_dict(params_from_jax(params))
    tt.loader = JaxKeyDraws(tt.loader, _fcos_draws(tcfg.SEMISUPNET.BURN_UP_STEP))
    tt.storage.log_period = 1
    tt.train()
    return read_metrics(jcfg.OUTPUT_DIR), read_metrics(tcfg.OUTPUT_DIR), tt


def test_metrics_per_iteration_match_jax(runs):
    j_lines, t_lines, _ = runs
    assert len(j_lines) == len(t_lines) == 4
    for i, (j, t) in enumerate(zip(j_lines, t_lines)):
        assert t["iteration"] == j["iteration"] == i + 1
        assert set(j) <= set(t), set(j) - set(t)
        assert t["time"] > 0 and t["data_time"] >= 0 and t["corrupt_rows_total"] == 0
        for k in EXACT:
            if k in j:
                assert t[k] == j[k], (i, k)
        for k, v in j.items():
            if k not in UNCOMPARED:
                np.testing.assert_allclose(t[k], v, rtol=2e-3, atol=1e-5, err_msg=f"iteration {i + 1} {k}")
    mutual = t_lines[2:]
    assert [m["ema_rate_1000x"] for m in mutual] == [0.0, j_lines[3]["ema_rate_1000x"]]
    assert all(m["num_pseudo_cls"] > 0 and m["num_pseudo_reg"] > 0 for m in mutual)
    assert "loss_fcos_cls_pseudo" not in t_lines[0]


def test_run_writes_checkpoint_and_evaluates(runs):
    _, _, trainer = runs
    assert trainer.state.step == 4
    assert trainer.checkpointer.steps() == [4]
    results = trainer.test(model="teacher")
    assert {"AP", "AP50", "AP75"} <= set(results) and np.isfinite(results["AP"])


def _snapshot(trainer):
    return copy.deepcopy(trainer.checkpoint_state())


def _assert_state_equal(a, b):
    for part in ("student", "teacher"):
        assert set(a[part]) == set(b[part])
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    sa, sb = a["optimizer"]["sgd"]["state"], b["optimizer"]["sgd"]["state"]
    assert set(sa) == set(sb) and len(sa) > 0
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"]), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    assert a["step"] == b["step"]
    assert torch.equal(a["generator"], b["generator"])


@pytest.mark.usefixtures("large_files_removed")
def test_checkpoint_resume_is_bitwise(tmp_path):
    """Train 4 iterations (checkpoints at 2 and 4), then a new trainer with
    resume=True restores student, teacher, momentum buffers, update count,
    step and generator state bitwise and, with MAX_ITER raised by 2, takes
    2 more steps from iteration 4; resume=False ignores the checkpoints."""
    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

    dicts, image_loader = synthetic_coco(size=48)
    datasets = trainer_datasets(dicts)
    _, cfg = trainer_cfgs(tmp_path, extra_opts=SMALL + ["SOLVER.CHECKPOINT_PERIOD", "2"])
    t1 = UBTeacherTrainer(cfg, datasets=datasets, image_loader=image_loader, device="cpu")
    t1.resume_or_load(resume=False)
    t1.train()
    saved = _snapshot(t1)
    assert t1.checkpointer.steps() == [2, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(t1.checkpointer.directory))

    t2 = UBTeacherTrainer(cfg, datasets=datasets, image_loader=image_loader, device="cpu")
    fresh = _snapshot(t2)
    t2.resume_or_load(resume=True)
    assert t2.start_iter == 4
    _assert_state_equal(_snapshot(t2), saved)

    _, cfg6 = trainer_cfgs(tmp_path, extra_opts=SMALL + ["SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.MAX_ITER", "6"])
    t3 = UBTeacherTrainer(cfg6, datasets=datasets, image_loader=image_loader, device="cpu")
    t3.resume_or_load(resume=True)
    assert t3.start_iter == 4
    t3.train()
    assert t3.state.step == 6 and t3.state.optimizer.count == 6
    assert t3.checkpointer.steps() == [2, 4, 6]
    lines = read_metrics(cfg.OUTPUT_DIR)
    assert len(lines) == 2 and all(np.isfinite(v) for line in lines for v in line.values())
    assert lines[-1]["ema_rate_1000x"] == pytest.approx(1000 * cfg.SEMISUPNET.EMA_KEEP_RATE)

    t4 = UBTeacherTrainer(cfg, datasets=datasets, image_loader=image_loader, device="cpu")
    t4.resume_or_load(resume=False)
    assert t4.start_iter == 0
    _assert_state_equal_models(_snapshot(t4), fresh)


def _assert_state_equal_models(a, b):
    for part in ("student", "teacher"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert a["step"] == b["step"] == 0


def test_checkpointer_keeps_five_and_ignores_partial_files(tmp_path):
    from ubteacher_tpu_torch.checkpoint import TSCheckpointer

    ck = TSCheckpointer(str(tmp_path))
    assert ck.latest_step() is None and ck.resume_or_load(True) is None
    for step in range(1, 8):
        ck.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert ck.steps() == [3, 4, 5, 6, 7]
    # a save cut before its rename leaves only a temporary file
    with open(os.path.join(ck.directory, ".8.tmp"), "wb") as f:
        f.write(b"partial")
    assert ck.latest_step() == 7
    got = ck.resume_or_load(True)
    assert got["step"] == 7 and torch.equal(got["w"], torch.full((2,), 7.0))
    assert ck.resume_or_load(False) is None


def test_auto_scale_workers_and_verify_results_match_jax():
    from ubteacher_tpu.config import add_ubteacher_config, get_cfg
    from ubteacher_tpu.engine.trainer import auto_scale_workers as j_scale, verify_results as j_verify
    from ubteacher_tpu_torch.config import add_ubteacher_config as t_add, get_cfg as t_get
    from ubteacher_tpu_torch.engine.trainer import auto_scale_workers, verify_results

    cfgs = []
    for get, add in ((get_cfg, add_ubteacher_config), (t_get, t_add)):
        cfg = get()
        add(cfg)
        cfg.SOLVER.REFERENCE_WORLD_SIZE = 8
        cfg.SOLVER.IMG_PER_BATCH_LABEL = 32
        cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 32
        cfg.SOLVER.BASE_LR = 0.01
        cfg.SOLVER.MAX_ITER = 180000
        cfg.SOLVER.STEPS = (179990,)
        cfg.TEST.EXPECTED_RESULTS = [["AP", 30.0, 1.0]]
        cfg.freeze()
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    for n in (1, 4, 8, 16):
        assert json.dumps(auto_scale_workers(tcfg, n), sort_keys=True, default=str) == json.dumps(
            j_scale(jcfg, n), sort_keys=True, default=str)
    one = auto_scale_workers(tcfg, 1)
    assert one.SOLVER.IMG_PER_BATCH_LABEL == 4 and one.SOLVER.MAX_ITER == 1440000
    assert tcfg.SOLVER.IMG_PER_BATCH_LABEL == 32  # the input is not changed
    assert auto_scale_workers(tcfg, 8) is tcfg
    for results in ({"AP": 30.5}, {"AP": 28.0}, {}):
        assert verify_results(tcfg, results) == j_verify(jcfg, results)


@pytest.mark.usefixtures("large_files_removed")
def test_profile_dir_writes_a_trace_from_step_10(tmp_path, monkeypatch):
    """UBT_PROFILE_DIR: a torch.profiler trace from the run's iteration 10
    (to 20, or to the end of a shorter run: here iteration 10 alone), with
    the loop's and the step's spans."""
    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer

    dicts, image_loader = synthetic_coco(size=48)
    _, cfg = trainer_cfgs(tmp_path, extra_opts=SMALL + ["SOLVER.MAX_ITER", "11", "SEMISUPNET.BURN_UP_STEP", "100"])
    monkeypatch.setenv("UBT_PROFILE_DIR", str(tmp_path / "trace"))
    trainer = UBTeacherTrainer(cfg, datasets=trainer_datasets(dicts), image_loader=image_loader, device="cpu")
    trainer.train()
    traces = os.listdir(tmp_path / "trace")
    assert traces == ["trace_iter10.json"]
    with open(tmp_path / "trace" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    names = {e.get("name") for e in events}
    assert {"ubt.train.iteration", "ubt.step", "ubt.step.student_forward", "ubt.step.backward"} <= names


def test_device_none_means_the_card(monkeypatch):
    """device=None asks for the first card: without one the trainer raises
    instead of running on the CPU."""
    from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = trainer_cfgs("unused")
    dicts, image_loader = synthetic_coco()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UBTeacherTrainer(cfg, datasets=trainer_datasets(dicts), image_loader=image_loader)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UBTeacherTrainer(cfg, datasets=trainer_datasets(dicts), image_loader=image_loader, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
