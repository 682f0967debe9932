"""Training CLI of the PyTorch port, with the surface of the reference's
train_net.py (reference: train_net.py:15-73) and of the JAX package's:

    python -m ubteacher_tpu_torch.train_net \\
        --config configs/FCOS/coco-standard/fcos_R_50_ut2_sup1_run0.yaml \\
        [--eval-only] [--resume] [--num-gpus N] [--num-machines M \\
        --machine-rank R --dist-url tcp://host:port] KEY VALUE ...

`MODEL.DEVICE cpu` selects the CPU; any other value (the shared default is
"tpu") means the cards, and a run without one stops. `--eval-only` evaluates
the teacher: of the newest checkpoint with `--resume`, or of a
reference-format checkpoint given as `MODEL.WEIGHTS x.pth`.

Data parallelism (parallel/dist.py): `--num-gpus N` runs N ranks on this
machine, one process per card (cuda:0..N-1, nccl), or with `MODEL.DEVICE
cpu` N CPU processes (gloo); `--num-machines`, `--machine-rank` and
`--dist-url` mean what they mean in detectron2 (`auto`: a free localhost
port, one machine). The batch sizes stay global and must divide by the
ranks. `--num-gpus` above the visible cards raises. `UBT_MULTIHOST=1` is the
JAX CLI's environment form: this process is rank UBT_PROCESS_ID of
UBT_NUM_PROCESSES, meeting at tcp://UBT_COORDINATOR (its card is
LOCAL_RANK's, default 0).
"""

from __future__ import annotations

import argparse
import os


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ubteacher_tpu_torch training")
    parser.add_argument("--config-file", "--config", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=1, help="ranks (cards, or CPU processes) per machine")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto", help="tcp://host:port of rank 0; auto: a free localhost port")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="'KEY VALUE' config overrides")
    return parser


def setup(args):
    from .config import add_ubteacher_config, get_cfg

    cfg = get_cfg()
    add_ubteacher_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def device_of(cfg) -> str:
    """MODEL.DEVICE "cpu" -> the CPU; anything else -> the rank's card."""
    from .parallel import local_rank

    return "cpu" if str(cfg.MODEL.DEVICE).lower() == "cpu" else f"cuda:{local_rank()}"


def main(args) -> dict | None:
    """One rank's run (the whole run with one process)."""
    cfg = setup(args)
    trainer_name = cfg.SEMISUPNET.Trainer
    if trainer_name == "ubteacher":
        from .engine.trainer import UBTeacherTrainer as Trainer
    elif trainer_name == "ubteacher_rcnn":
        from .engine.trainer import UBRCNNTeacherTrainer as Trainer
    else:
        raise ValueError(f"Trainer Name is not found: {trainer_name}")

    trainer = Trainer(cfg, device=device_of(cfg))
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        results = trainer.test(model="teacher")
        print(results)
        return results
    trainer.train()
    return None


def run(args) -> dict | None:
    """The command line's run: checks the ranks against the cards and the
    batch, then runs `main` on every rank (parallel.launch, or this process
    as one rank of an UBT_MULTIHOST run)."""
    import torch

    from .parallel import default_backend, init_distributed, launch, owned_rows

    cfg = setup(args)
    device_type = "cpu" if device_of(cfg) == "cpu" else "cuda"
    if device_type == "cuda" and args.num_gpus > torch.cuda.device_count():
        raise ValueError(f"--num-gpus {args.num_gpus}: {torch.cuda.device_count()} cards are visible")
    backend = default_backend(device_type)
    if os.environ.get("UBT_MULTIHOST") == "1":
        world = int(os.environ["UBT_NUM_PROCESSES"])
    else:
        world = args.num_gpus * args.num_machines
    for b in (cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.IMG_PER_BATCH_UNLABEL):
        owned_rows(b, 0, world)  # raises unless the ranks divide the global batch
    if os.environ.get("UBT_MULTIHOST") == "1":
        init_distributed(backend, f"tcp://{os.environ['UBT_COORDINATOR']}", world,
                         int(os.environ["UBT_PROCESS_ID"]))
        return main(args)
    return launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url,
                  backend=backend if world > 1 else None, args=(args,))


if __name__ == "__main__":
    run(default_argument_parser().parse_args())
