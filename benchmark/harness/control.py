"""The readings a cell's correctness limits are set from, on the chip:
the control (the plain reference computed with float8 operands in every
convolution and matrix product, the step below the program's bfloat16) put
in the program's place, against the reference in float32, on several seeds
at the cell's own size. The program's own readings come from the runs of
`benchmark.run` (the `checks` of each result).

    python -m benchmark.harness.control --workload fcos_mutual_recipe --seeds 1 2 3

prints one JSON line a seed: {"seed", "control": {number: value}}."""

from __future__ import annotations

import argparse
import json
import math

import torch

from . import compare, manifest, traffic as traffic_mod
from .refrun import reference_steps


def control_readings(workload: str, seed: int, device, cfg_extra=None, mix_extra=None) -> dict:
    man = manifest.manifest()
    cell = manifest.workload(man, workload)
    conf = manifest.config(cell["config"])
    mix = dict(manifest.traffic(cell["traffic"]), **(mix_extra or {}))
    extra = dict({"SEED": seed}, **(cfg_extra or {}))
    threads = int(dict(conf["cfg"], **(cfg_extra or {})).get("TPU.DATA_THREADS", 8))
    pool, dicts = traffic_mod.make_pool(mix, seed, threads=threads)
    steps = int(mix["check_steps"])
    ref = reference_steps(conf, extra, seed, pool, dicts, steps, device)
    ctl = reference_steps(conf, extra, seed, pool, dicts, steps, device, lower_precision=True)
    return dict(compare.readings(ctl, ref), **compare.step_gaps(ctl, ref))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the control runs on the card")
    for seed in args.seeds:
        numbers = control_readings(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "control": {k: v if isinstance(v, str) or math.isfinite(v) else str(v)
                                                     for k, v in numbers.items()}}), flush=True)


if __name__ == "__main__":
    main()
