"""The plain reference's run of the R-CNN train cell's first steps, with
the decision replay: the frozen R-CNN steps of reference/ubtref in float32
with TF32 off, fed by the frozen two-stream loader (synchronous) from the
same JPEG pool and seed, from the same weights, with the same seeded device
generator for the strong augmentation and the samplers' draws, taking the
compared run's discrete choices where they are admissible
(reference/ubtref/engine/replay.py). `lower_precision` runs the same steps
with float8 operands in every convolution and matrix product (the control,
harness/refrun.py's `Float8Products`)."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from . import cfgs, compare, weights as weights_mod
from .refrun import Float8Products, _to_device


def reference_steps(conf: Dict, cfg_extra: Dict, seed: int, pool, dicts: Dict, steps: int, device,
                    lower_precision: bool = False, program: Optional[List[Dict[str, list]]] = None,
                    **band) -> Tuple[Dict, object]:
    """-> (readings, the run's `Choices`). The readings are those of
    harness/refrun.py (`losses`, `first_losses`, `grad`, `change`,
    `teacher`). `program`: the compared run's recorded choices, step by
    step (None: the reference chooses alone); `band`: eps / delta in place
    of the replay's own."""
    from ..reference.ubtref import config as ref_config
    from ..reference.ubtref.data.loader import TwoStreamDataLoader
    from ..reference.ubtref.engine.fcos_trainer import FCOSTrainState
    from ..reference.ubtref.engine.rcnn_trainer import make_rcnn_train_steps
    from ..reference.ubtref.engine.replay import Choices
    from ..reference.ubtref.modeling.rcnn import build_two_stage_rcnn
    from ..reference.ubtref.solver import build_optimizer

    extra = dict(cfg_extra, **{"TPU.COMPUTE_DTYPE": "float32", "TPU.DATA_THREADS": 0})
    cfg = cfgs.build(ref_config, conf["cfg"], extra)
    model = build_two_stage_rcnn(cfg, device, torch.Generator().manual_seed(0))
    w0 = weights_mod.make_weights(weights_mod.param_shapes(model), conf["init"], seed, device)
    weights_mod.load_into(model, w0)
    state = FCOSTrainState.create(model, build_optimizer(cfg, model))
    choices = Choices(program, **band)
    burnin, mutual = make_rcnn_train_steps(cfg, choices)
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
    return out, choices
