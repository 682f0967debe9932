"""Optimizer and LR schedules (PyTorch port of ubteacher_tpu.solver.build).

SGD + momentum with detectron2's per-parameter weight decay and bias-LR
rules, linear/constant warmup, and the multi-step, two-stage FACTOR_LIST and
cosine schedules. Freezing follows detectron2 itself: frozen parameters
(FrozenBN everywhere, the stem and res2..res{FREEZE_AT}) get
requires_grad=False, so autograd computes no gradient for them at all (the
JAX package reaches the same end with stop_gradient plus an optax mask).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """WarmupMultiStepLR / WarmupTwoStageMultiStepLR / WarmupCosineLR as a
    function of the optimizer's update count."""
    base_lr = cfg.SOLVER.BASE_LR
    steps = tuple(cfg.SOLVER.STEPS)
    gamma = cfg.SOLVER.GAMMA
    warmup_iters = cfg.SOLVER.WARMUP_ITERS
    warmup_factor = cfg.SOLVER.WARMUP_FACTOR
    warmup_method = cfg.SOLVER.WARMUP_METHOD
    name = cfg.SOLVER.LR_SCHEDULER_NAME
    factor_list = tuple(cfg.SOLVER.FACTOR_LIST)
    if name == "WarmupTwoStageMultiStepLR" and len(factor_list) != len(steps) + 1:
        raise ValueError("Length of milestones should match length of factor_list.")

    def warmup(step: int) -> float:
        if step >= warmup_iters:
            return 1.0
        if warmup_method == "constant":
            return warmup_factor
        alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        return warmup_factor * (1 - alpha) + alpha

    def schedule(step: int) -> float:
        if name == "WarmupTwoStageMultiStepLR":
            factor = float(factor_list[0])
            for i, milestone in enumerate(steps):
                if step >= milestone:
                    factor = float(factor_list[i + 1])
            lr = base_lr * factor
        elif name == "WarmupCosineLR":
            lr = base_lr * 0.5 * (1.0 + math.cos(math.pi * step / max(cfg.SOLVER.MAX_ITER, 1)))
        else:  # WarmupMultiStepLR
            lr = base_lr * gamma ** sum(step >= m for m in steps)
        return lr * warmup(step)

    return schedule


def trainable_mask(model: nn.Module, freeze_at: int = 2) -> Dict[str, bool]:
    """{parameter name: trainable}. Frozen: FrozenBN scale/bias everywhere,
    the stem, and res2..res{freeze_at} (detectron2 FREEZE_AT semantics)."""

    def trainable(name: str) -> bool:
        if "_norm" in name:
            return False
        if freeze_at >= 1 and "stem_" in name:
            return False
        return not any(f"res{stage}_block" in name for stage in range(2, freeze_at + 1))

    return {name: trainable(name) for name, _ in model.named_parameters()}


def freeze_parameters(model: nn.Module, freeze_at: int = 2) -> None:
    """requires_grad=False on every frozen parameter: the counterpart of the
    JAX package's stop_frozen_gradients, so no dead backward runs."""
    mask = trainable_mask(model, freeze_at)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])


def _is_norm(name: str) -> bool:
    """GroupNorm (`*_gn{i}`) and FrozenBN (`*_norm`) parameters."""
    return "_gn" in name or "_norm" in name


def optimizer_hyperparams(cfg, name: str) -> Tuple[float, float]:
    """(weight_decay, lr_factor) of one parameter, as detectron2's
    get_default_optimizer_params gives them: WEIGHT_DECAY_NORM for norm
    parameters, WEIGHT_DECAY_BIAS (when set) and BIAS_LR_FACTOR for biases
    (the bias rule applies after the norm rule), else WEIGHT_DECAY."""
    leaf = name.rsplit(".", 1)[-1]
    decay = cfg.SOLVER.WEIGHT_DECAY_NORM if _is_norm(name) else cfg.SOLVER.WEIGHT_DECAY
    if leaf == "bias" and cfg.SOLVER.WEIGHT_DECAY_BIAS is not None:
        decay = cfg.SOLVER.WEIGHT_DECAY_BIAS
    factor = cfg.SOLVER.BIAS_LR_FACTOR if leaf == "bias" else 1.0
    return float(decay), float(factor)


class Optimizer:
    """SGD + momentum over the model's trainable parameters, one parameter
    group per (weight decay, lr factor) pair, with the schedule evaluated at
    the update count and optional gradient clipping first.

    An update is torch.optim.SGD's arithmetic (weight decay, momentum,
    nesterov), written as foreach ops whose every changing input lives on
    the device, so that a CUDA graph can capture it once and replay it at
    every count: `prepare` is the host's half (the count's learning rate
    into one device scalar a group, SGD's state pointed at the optimizer's
    own momentum buffers), `update` the device's, and `step` both; inside
    `prepared()`, which runs `prepare` once, `step` is `update` alone (what
    a captured step calls). `sgd` keeps the groups and the state, so
    state_dict() keeps torch's format; its state's
    "momentum_buffer" of a parameter is the optimizer's own buffer, and one
    put there in its place (load_state_dict) or taken away (state.clear())
    is copied in or zeroed by the next `prepare`: a zeroed buffer gives
    torch's first update, buf = grad, exactly."""

    def __init__(self, cfg, model: nn.Module):
        self.schedule = build_lr_schedule(cfg)
        clip = cfg.SOLVER.CLIP_GRADIENTS
        self.clip_type = clip.CLIP_TYPE if clip.ENABLED else None
        self.clip_value = clip.CLIP_VALUE
        groups: Dict[Tuple[float, float], list] = {}
        for name, p in model.named_parameters():
            if p.requires_grad:
                groups.setdefault(optimizer_hyperparams(cfg, name), []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.sgd = torch.optim.SGD(
            [{"params": ps, "weight_decay": wd, "lr_factor": f} for (wd, f), ps in groups.items()],
            lr=self.schedule(0),
            momentum=cfg.SOLVER.MOMENTUM,
            nesterov=cfg.SOLVER.NESTEROV,
        )
        self.count = 0
        self.grads: Optional[List[torch.Tensor]] = None  # fixed gradient tensors (static_grads)
        self._neg_lr: Optional[List[torch.Tensor]] = None  # -lr of each group, on the device
        self._bufs: Optional[List[List[torch.Tensor]]] = None  # each group's momentum buffers
        self._held = False  # inside prepared(): step() is update() alone

    def zero_grad(self) -> None:
        """No gradients; or, once they are fixed (static_grads), each
        parameter's own gradient tensor zeroed in place."""
        if self.grads is None:
            self.sgd.zero_grad(set_to_none=True)
        else:
            self.bind_grads()
            torch._foreach_zero_(self.grads)

    def static_grads(self) -> bool:
        """Fix each trained parameter's gradient at the tensor it holds now,
        zeroed in place by every later zero_grad, so that a captured
        backward accumulates into tensors that outlive the capture. False,
        and nothing fixed, where a parameter holds no gradient (an unused
        parameter, which torch's SGD skips and a fixed zero would not)."""
        if self.grads is None:
            if any(p.grad is None for p in self.params):
                return False
            self.grads = [p.grad for p in self.params]
        return True

    def bind_grads(self) -> None:
        """Point each parameter's .grad back at its fixed tensor (a caller
        may have set it to another, or to None)."""
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g

    def prepare(self) -> None:
        """The host's half of update `count`: each group's learning rate
        into its device scalar, the momentum buffers into SGD's state."""
        groups = self.sgd.param_groups
        if self._neg_lr is None:
            device = self.params[0].device if self.params else torch.device("cpu")
            self._neg_lr = [torch.zeros((), dtype=torch.float32, device=device) for _ in groups]
            if any(g["momentum"] for g in groups):
                self._bufs = [[torch.zeros_like(p) for p in g["params"]] for g in groups]
        lr = self.schedule(self.count)
        for group, neg_lr in zip(groups, self._neg_lr):
            group["lr"] = lr * group["lr_factor"]
            neg_lr.fill_(-group["lr"])
        if self._bufs is not None:
            self._own_momentum_buffers()
        self.count += 1

    def _own_momentum_buffers(self) -> None:
        state = self.sgd.state
        zeroed, held, own = [], [], []
        for group, bufs in zip(self.sgd.param_groups, self._bufs):
            for p, buf in zip(group["params"], bufs):
                was = state[p].get("momentum_buffer")
                if was is buf:
                    continue
                if was is None:
                    zeroed.append(buf)
                else:
                    held.append(was)
                    own.append(buf)
                state[p]["momentum_buffer"] = buf
        if zeroed:
            torch._foreach_zero_(zeroed)
        if own:
            torch._foreach_copy_(own, held)

    @torch.no_grad()
    def update(self) -> None:
        """The device's half: clip, then torch.optim.SGD's update with the
        prepared learning rates. A parameter without a gradient is left as
        it is, as torch leaves it."""
        if self.clip_type == "value":
            nn.utils.clip_grad_value_(self.params, self.clip_value)
        elif self.clip_type is not None:
            nn.utils.clip_grad_norm_(self.params, self.clip_value, norm_type=2.0)
        bufs_of = self._bufs or [None] * len(self._neg_lr)
        for group, neg_lr, all_bufs in zip(self.sgd.param_groups, self._neg_lr, bufs_of):
            have = [i for i, p in enumerate(group["params"]) if p.grad is not None]
            params = [group["params"][i] for i in have]
            if not params:
                continue
            d = [p.grad for p in params]
            if group["weight_decay"]:
                d = torch._foreach_add(d, params, alpha=group["weight_decay"])
            momentum = group["momentum"]
            if momentum:
                bufs = [all_bufs[i] for i in have]
                torch._foreach_mul_(bufs, momentum)
                torch._foreach_add_(bufs, d, alpha=1 - group["dampening"])
                d = torch._foreach_add(d, bufs, alpha=momentum) if group["nesterov"] else bufs
            # param + (-lr) * d in one rounding, as torch's add(alpha=-lr)
            torch._foreach_addcmul_(params, d, [neg_lr] * len(params))

    def step(self) -> None:
        if not self._held:
            self.prepare()
        self.update()

    @contextlib.contextmanager
    def prepared(self) -> Iterator[None]:
        """prepare() now, for the one update that the steps inside make: a
        step run eagerly, its capture as a CUDA graph, or a replay of one."""
        self.prepare()
        self._held = True
        try:
            yield
        finally:
            self._held = False

    def state_dict(self) -> Dict:
        """SGD's state (the momentum buffers) and the update count."""
        return {"sgd": self.sgd.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])


def build_optimizer(cfg, model: nn.Module) -> Optimizer:
    """Freeze per MODEL.BACKBONE.FREEZE_AT, then SGD over what trains."""
    freeze_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    return Optimizer(cfg, model)
