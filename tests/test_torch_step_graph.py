"""What the mutual step's CUDA graphs (engine/step_graph.py) rest on, on the
CPU: the EMA at rates read from a device tensor gives the float rate's
teacher bit for bit; the optimizer's update with learning rates read from
device tensors gives torch.optim.SGD's parameters and momentum buffers bit
for bit, from a fresh state, after SGD's state is cleared and after a state
is loaded, stepped alone or inside prepared(); the mutual step updates
through the trainer module's sgd_step, once a step; a batch's tensors go
into static views and come back in its structure. (The graphs themselves
run only on the card: test_torch_step_graph_card.py.)"""

import copy

import pytest
import torch
from torch import nn

from torch_parity import few_torch_threads, tmp_budget  # noqa: F401 (autouse fixtures)
from torch_parity import CFG_PATH, SMALL_OPTS, port_instances, synthetic_batch
from ubteacher_tpu_torch.engine.fcos_trainer import FCOSTrainState, _ema_update, ema_rates


class Tiny(nn.Module):
    """A convolution, a GroupNorm (the weight-decay-free group, as the FCOS
    head's `*_gn*`) and a linear layer with biases (the bias LR factor)."""

    def __init__(self, seed: int):
        super().__init__()
        torch.manual_seed(seed)
        self.conv = nn.Conv2d(3, 4, 3)
        self.head_gn1 = nn.GroupNorm(2, 4)
        self.fc = nn.Linear(4, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.normal_()


@pytest.mark.parametrize("keep", [0.0, 0.9999, 1.0])
def test_ema_at_device_rates_equals_the_float_rate(keep):
    teacher, student = Tiny(0), Tiny(1)
    want = Tiny(0)
    _ema_update(want, student, keep)
    state = FCOSTrainState(step=0, student=student, teacher=teacher, optimizer=None)
    _ema_update(teacher, student, ema_rates(state, keep))
    for (name, got), ref in zip(teacher.named_parameters(), want.parameters()):
        assert torch.equal(got, ref), name
        assert got.view(torch.int32).equal(ref.view(torch.int32)), name  # the bits, signed zeros too
    if keep == 1.0:
        assert all(torch.equal(p, q) for p, q in zip(teacher.parameters(), Tiny(0).parameters()))


def _cfg(nesterov: bool):
    from ubteacher_tpu_torch.config import add_ubteacher_config, get_cfg

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    cfg.merge_from_list(["SOLVER.BASE_LR", "0.1", "SOLVER.WARMUP_ITERS", "4", "SOLVER.WEIGHT_DECAY", "0.01",
                         "SOLVER.WEIGHT_DECAY_NORM", "0.0", "SOLVER.BIAS_LR_FACTOR", "2.0",
                         "SOLVER.MOMENTUM", "0.9", "SOLVER.NESTEROV", str(nesterov)])
    return cfg


def _torch_sgd(opt):
    """torch.optim.SGD over the optimizer's groups, with its hyperparameters."""
    groups = [{k: v for k, v in g.items()} for g in opt.sgd.param_groups]
    return torch.optim.SGD(groups, lr=groups[0]["lr"], momentum=groups[0]["momentum"],
                           nesterov=groups[0]["nesterov"])


def _torch_step(sgd, opt, count, grads):
    for group in sgd.param_groups:
        group["lr"] = opt.schedule(count) * group["lr_factor"]
    for p, g in zip((p for group in sgd.param_groups for p in group["params"]), grads):
        p.grad = g.clone()
    sgd.step()


@pytest.mark.parametrize("held", [False, True], ids=["step", "prepared_step"])
@pytest.mark.parametrize("start", ["fresh", "state_cleared", "state_loaded"])
def test_sgd_at_device_learning_rates_equals_torch_sgd(start, held):
    from ubteacher_tpu_torch.solver.build import Optimizer

    nesterov = start == "state_loaded"
    model, ref_model = Tiny(0), Tiny(0)
    opt = Optimizer(_cfg(nesterov), model)
    assert sorted(g["weight_decay"] for g in opt.sgd.param_groups) == [0.0, 0.0, 0.01, 0.01]
    gen = torch.Generator().manual_seed(3)

    def grads():
        return [torch.randn(p.shape, generator=gen) for p in opt.params]

    if start != "fresh":
        for _ in range(2):  # a state to clear or to carry over
            for p, g in zip(opt.params, grads()):
                p.grad = g
            opt.step()
    with torch.no_grad():
        for p, q in zip(ref_model.parameters(), model.parameters()):
            p.copy_(q)
    ref = _torch_sgd(Optimizer(_cfg(nesterov), ref_model))
    count = opt.count
    if start == "state_cleared":
        opt.sgd.state.clear()
        opt.count = count = 0
    elif start == "state_loaded":
        # momentum buffers as a checkpoint holds them, loaded into both
        ref_state = ref.state_dict()
        ref_state["state"] = {i: {"momentum_buffer": torch.randn(p.shape, generator=gen)}
                              for i, p in enumerate(opt.params)}
        ref.load_state_dict(copy.deepcopy(ref_state))
        opt.load_state_dict({"sgd": copy.deepcopy(ref_state), "count": count})
    for _ in range(3):
        g = grads()
        for p, gi in zip(opt.params, g):
            p.grad = gi.clone()
        _torch_step(ref, opt, count, g)
        if held:  # the host's half first, then the update alone (a graphed step's)
            with opt.prepared():
                opt.step()
        else:
            opt.step()
        count += 1
        ref_params = [p for group in ref.param_groups for p in group["params"]]
        for p, q in zip(opt.params, ref_params):
            assert torch.equal(p, q)
            assert torch.equal(opt.sgd.state[p]["momentum_buffer"], ref.state[q]["momentum_buffer"])
    assert opt.count == count


def test_batch_leaves_go_into_views_and_back():
    from ubteacher_tpu_torch.engine.step_graph import _leaves, _replace_leaves
    from ubteacher_tpu_torch.structures import PaddedInstances

    gt = PaddedInstances(*(torch.full((2, 3), float(i)) for i in range(5)))
    batch = {"images_label_k": torch.zeros(2, 4, 6, 3, dtype=torch.uint8), "gt_label": gt,
             "label_hw": torch.ones(2, 2), "rng": torch.Generator()}
    leaves = dict(_leaves(batch))
    assert list(leaves) == ["images_label_k", "gt_label.boxes", "gt_label.classes", "gt_label.scores",
                            "gt_label.box_std", "gt_label.mask", "label_hw"]
    views = {k: v.clone() + 1 for k, v in leaves.items()}
    out = _replace_leaves(batch, views)
    assert out["rng"] is batch["rng"] and isinstance(out["gt_label"], PaddedInstances)
    assert dict(_leaves(out)).keys() == leaves.keys()
    assert all(got is views[k] for k, got in _leaves(out))


@pytest.mark.parametrize("update", ["sgd_step", "no_update"])
def test_the_mutual_step_updates_through_sgd_step(update, monkeypatch):
    """The mutual step reaches its backward and update through the trainer
    module's sgd_step, once a step, with one prepared learning rate: a
    patch of that name (the benchmark's planted fault) reaches it."""
    from ubteacher_tpu_torch.config import add_ubteacher_config, get_cfg
    from ubteacher_tpu_torch.engine import fcos_trainer
    from ubteacher_tpu_torch.modeling.fcos_head import build_one_stage_detector
    from ubteacher_tpu_torch.solver import build_optimizer

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    cfg.merge_from_file(CFG_PATH)
    cfg.merge_from_list(SMALL_OPTS)
    cfg.freeze()
    model = build_one_stage_detector(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = fcos_trainer.FCOSTrainState.create(model, build_optimizer(cfg, model))
    state.step = cfg.SEMISUPNET.BURN_UP_STEP
    calls = []
    real = fcos_trainer.sgd_step

    def counted(st, total):
        calls.append(st.optimizer.count)
        if update == "sgd_step":
            real(st, total)
        else:  # backward without an update, the fault's
            st.optimizer.zero_grad()
            total.backward()
            st.step += 1

    monkeypatch.setattr(fcos_trainer, "sgd_step", counted)
    _, mutual = fcos_trainer.make_fcos_train_steps(cfg)
    images, boxes, classes, mask = synthetic_batch(3, 2, 4, cfg.TPU.MAX_GT)
    batch = {"images_label_k": torch.from_numpy(images), "gt_label": port_instances(boxes, classes, mask),
             "images_unlabel_k": torch.from_numpy(images), "rng": torch.Generator().manual_seed(0)}
    before = [p.detach().clone() for p in state.student.parameters()]
    for i in range(2):
        state, metrics = mutual(state, batch)
        assert state.step == cfg.SEMISUPNET.BURN_UP_STEP + i + 1
    assert calls == [1, 2] and state.optimizer.count == 2  # each prepared once, before its update
    unchanged = all(torch.equal(p, q) for p, q in zip(state.student.parameters(), before))
    assert unchanged == (update == "no_update")
    assert torch.isfinite(metrics["total_loss"])
