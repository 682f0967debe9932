"""The plain reference's run of a train cell's first steps: the frozen copy
of the steps in float32 with TF32 off, fed by the frozen copy of the
two-stream loader (synchronous) from the same JPEG pool and seed, from the
same weights, with the same seeded device generator for the strong
augmentation and sampling draws. It works out again everything the
program derived: batches, pseudo labels, losses, updates, the EMA teacher.

`lower_precision` runs the same steps with every convolution and matrix
product fed 8-bit floats (float8 e4m3, one scale per tensor, as fp8
training recipes scale): the control, the step below the program's
bfloat16 that a later change might be tempted to take."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from . import cfgs, compare, weights as weights_mod

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round a float tensor through float8 e4m3 with a per-tensor scale; the
    gradient passes the rounding unchanged (fake quantisation), as in fp8
    training, where the products' operands are rounded and the backward
    flows through them."""
    if not t.is_floating_point():
        return t
    x = t.detach()
    amax = x.abs().amax().float().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    return t + (q - x)


class Float8Products(TorchFunctionMode):
    """Feeds convolutions and matrix products float8-rounded operands."""

    PRODUCTS = {F.conv2d, F.linear, torch.matmul, torch.mm, torch.bmm, torch.Tensor.matmul, torch.Tensor.__matmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            args = tuple(_fp8(a) if isinstance(a, torch.Tensor) and i < 2 else a for i, a in enumerate(args))
            if "weight" in kwargs:
                kwargs = dict(kwargs, weight=_fp8(kwargs["weight"]))
        return func(*args, **kwargs)


def _to_device(batch: Dict, device) -> Dict:
    """The trainer's host -> device conversion (numpy to tensors, the gt's
    classes to int64), without pinned memory or a copy stream."""
    import numpy as np

    from ..reference.ubtref.structures import PaddedInstances

    def value(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v).to(device)
        if isinstance(v, PaddedInstances):
            out = v.map(lambda x: torch.from_numpy(x).to(device))
            out.classes = out.classes.long()
            return out
        return v

    return {k: value(v) for k, v in batch.items()}


def reference_steps(conf: Dict, cfg_extra: Dict, seed: int, pool, dicts: Dict, steps: int, device,
                    lower_precision: bool = False) -> Dict:
    """-> {"losses": [total loss of each step], "first_losses": {each loss
    term of the first step}, "grad": {leaf: first gradient's norm},
    "change": {leaf: norm of its change after `steps`}, "teacher": {leaf:
    norm of the EMA teacher's change after `steps`}}."""
    from ..reference.ubtref import config as ref_config
    from ..reference.ubtref.data.loader import TwoStreamDataLoader
    from ..reference.ubtref.engine.fcos_trainer import FCOSTrainState, make_fcos_train_steps
    from ..reference.ubtref.modeling.fcos_head import build_one_stage_detector
    from ..reference.ubtref.solver import build_optimizer

    extra = dict(cfg_extra, **{"TPU.COMPUTE_DTYPE": "float32", "TPU.DATA_THREADS": 0})
    cfg = cfgs.build(ref_config, conf["cfg"], extra)
    model = build_one_stage_detector(cfg, device, torch.Generator().manual_seed(0))
    w0 = weights_mod.make_weights(weights_mod.param_shapes(model), conf["init"], seed, device)
    weights_mod.load_into(model, w0)
    state = FCOSTrainState.create(model, build_optimizer(cfg, model))
    burnin, mutual = make_fcos_train_steps(cfg)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run_seed = max(cfg.SEED, 0)
    loader = TwoStreamDataLoader(cfg, dicts["label"], dicts["unlabel"], seed=run_seed, image_loader=pool)
    gen = torch.Generator(device=device).manual_seed(run_seed + 17)
    names = {id(p): n for n, p in model.named_parameters()}
    out = {"losses": [], "first_losses": {}, "grad": {}, "change": {}, "teacher": {}}
    mode = Float8Products() if lower_precision else contextlib.nullcontext()
    it = iter(loader)
    with mode:
        for i in range(steps):
            batch = _to_device(next(it), device)
            batch["rng"] = gen
            step = burnin if i < cfg.SEMISUPNET.BURN_UP_STEP else mutual
            state, metrics = step(state, batch)
            out["losses"].append(float(metrics["total_loss"]))
            if i == 0:
                out["first_losses"] = {k: float(v) for k, v in metrics.items() if k.startswith("loss_")}
                out["grad"] = compare.to_host(compare.first_gradient_norms(state, names, w0))
    it.close()
    out["change"] = compare.to_host(compare.change_norms(state.student, w0))
    out["teacher"] = compare.to_host(compare.change_norms(state.teacher, w0, out["change"]))
    return out
