"""The FCOS train loop at full width (chip_smoke.py's train-loop data and
recipe: R-50, 80 classes, 8 + 8 images, the 768x1344 / 1344x768 canvases and
their 1024x1344 buckets) under UBTeacherTrainer.train(), with the loader at
several thread counts and with batches made beforehand (no loader thread
running), to tell whether the loader or its threads set the iteration's
pace. Prints each run's mutual iteration times (the metrics.json `time`)
and their median, and the median `data_time`; the boundary iteration and the
last one (which prefetches nothing) are left out. The first run warms the
process (cuDNN plans, allocator blocks for every canvas pair) and is only
logged.

    python3 port_tools/loop_threads.py   # from the repo root, on a GPU
"""
import os
import shutil
import statistics
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.engine.trainer import UBTeacherTrainer  # noqa: E402

ITERS, BURN = 12, 2
# (label, data threads, batches made beforehand), in turns
RUNS = (("warm-up, 8 threads", 8, False), ("8 threads", 8, False), ("made beforehand", 8, True),
        ("4 threads", 4, False), ("2 threads", 2, False), ("made beforehand", 8, True), ("8 threads", 8, False))


class MadeBeforehand:
    """Cycles through batches already taken from the loader."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        while True:
            for b in self.batches:
                yield dict(b)

    def close(self):
        pass


def run(label, threads, premade, datasets, image_loader, device):
    out = os.path.join(cs.ROOT, "ubteacher_tpu_torch", "_build", "loop_threads")
    shutil.rmtree(out, ignore_errors=True)
    cfg = cs.load_cfg(["SOLVER.IMG_PER_BATCH_LABEL", str(cs.BATCH_LABEL), "SOLVER.IMG_PER_BATCH_UNLABEL",
                       str(cs.BATCH_UNLABEL), "SOLVER.MAX_ITER", str(ITERS), "SEMISUPNET.BURN_UP_STEP", str(BURN),
                       "SOLVER.CHECKPOINT_PERIOD", str(10 * ITERS), "TEST.EVAL_PERIOD", "0",
                       "TPU.DATA_THREADS", str(threads), "MODEL.WEIGHTS", "", "OUTPUT_DIR", out])
    trainer = UBTeacherTrainer(cfg, datasets=datasets, image_loader=image_loader, device=device)
    trainer.storage.log_period = 1
    trainer.checkpointer.save = lambda *a, **k: None  # the iterations alone
    with torch.no_grad():
        trainer.state.student.head.cls_logits.bias.fill_(cs.SLICE_CLS_BIAS)
    if premade:
        it = iter(trainer.loader)
        batches = [next(it) for _ in range(8)]
        it.close()
        trainer.loader.close()
        trainer.loader = MadeBeforehand(batches)
    trainer.train()
    lines = [m for m in cs.read_lines(out) if "total_loss" in m][BURN + 1:-1]
    it_ms = [m["time"] * 1e3 for m in lines]
    dt_ms = [m["data_time"] * 1e3 for m in lines]
    cs.log(f"{label}: iteration ms {[round(x, 1) for x in it_ms]}, median {statistics.median(it_ms):.1f}; "
           f"data_time median {statistics.median(dt_ms):.1f} ms")
    del trainer
    shutil.rmtree(out, ignore_errors=True)


def main():
    device = torch.device("cuda", 0)
    cs.log(cs.gpu_name_and_power())
    cs.build_kernels()
    dicts, image_loader = cs.eval_dataset(cs.LOOP_IMAGES, 80, seed=3)
    datasets = {"train": dicts[:48], "train_unlabel": dicts[48:96], "test": dicts[96:], "meta": {}}
    for label, threads, premade in RUNS:
        run(label, threads, premade, datasets, image_loader, device)
    cs.log(cs.gpu_name_and_power())


if __name__ == "__main__":
    main()
