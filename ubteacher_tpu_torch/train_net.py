"""Training CLI of the PyTorch port, with the surface of the reference's
train_net.py (reference: train_net.py:15-73) and of the JAX package's:

    python -m ubteacher_tpu_torch.train_net \\
        --config configs/FCOS/coco-standard/fcos_R_50_ut2_sup1_run0.yaml \\
        [--eval-only] [--resume] [--num-gpus 1] KEY VALUE ...

Runs on the first card. `MODEL.DEVICE cpu` selects the CPU; any other value
(the shared default is "tpu") means the card, and a run without one stops.
`--eval-only` evaluates the teacher: of the newest checkpoint with
`--resume`, or of a reference-format checkpoint given as
`MODEL.WEIGHTS x.pth`. One process on one card: `--num-gpus` above 1 and
`--num-machines` above 1 raise NotImplementedError until the port has data
parallelism; `--machine-rank` and `--dist-url` are accepted for the
reference's command lines.
"""

from __future__ import annotations

import argparse


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ubteacher_tpu_torch training")
    parser.add_argument("--config-file", "--config", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=1, help="cards to train on (1 until data parallelism)")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="'KEY VALUE' config overrides")
    return parser


def setup(args):
    from .config import add_ubteacher_config, get_cfg

    if args.num_gpus > 1 or args.num_machines > 1:
        raise NotImplementedError(
            f"--num-gpus {args.num_gpus} --num-machines {args.num_machines}: the port trains on one card "
            "until it has data parallelism"
        )
    cfg = get_cfg()
    add_ubteacher_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def device_of(cfg) -> str:
    """MODEL.DEVICE "cpu" -> the CPU; anything else -> the first card."""
    return "cpu" if str(cfg.MODEL.DEVICE).lower() == "cpu" else "cuda:0"


def main(args) -> dict | None:
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


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
