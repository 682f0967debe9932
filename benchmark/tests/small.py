"""A train cell shrunk to run on the CPU in seconds: the tests' overrides
of the configuration and the traffic (the cells themselves run only at
their own sizes, on the card)."""

import time

import torch

# R-18 at 64 x 96 canvases, 2 + 2 images; the program in float32 so that its
# plain CPU paths meet the reference's
CFG = {"MODEL.RESNETS.DEPTH": 18, "TPU.CANVAS_LANDSCAPE": [64, 96], "TPU.CANVAS_PORTRAIT": [96, 64],
       "TPU.EXTRA_TRAIN_CANVASES": [], "TPU.TEST_CANVAS": [64, 96], "TPU.MAX_GT": 8, "TPU.MAX_PSEUDO": 20,
       "TPU.NMS_CANDIDATES": 100, "INPUT.MIN_SIZE_TRAIN": [48, 64], "INPUT.MAX_SIZE_TRAIN": 96,
       "SOLVER.IMG_PER_BATCH_LABEL": 2, "SOLVER.IMG_PER_BATCH_UNLABEL": 2, "TPU.COMPUTE_DTYPE": "float32",
       "TPU.DATA_THREADS": 2}
MIX = {"dims": [[60, 80], [80, 60]], "label": {"images": 12, "boxes": [1, 4]},
       "unlabel": {"images": 12, "boxes": [1, 4]}, "min_box": 8}
CPU = torch.device("cpu")


def run(workload="fcos_mutual_recipe", seed=3, seconds=0.5, trace=False):
    """benchmark.run's run_cell at the small size on the CPU."""
    from benchmark.run import run_cell

    return run_cell(workload, seed, seconds, trace, CPU, time.perf_counter(), CFG, MIX)
