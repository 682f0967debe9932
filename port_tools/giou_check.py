"""Build the kernels and run chip_smoke.py's GIoU rows alone: the forward and
backward kernels against their plain versions at the FCOS step's rows and on
the edge sets, bitwise across two launches, free of host syncs, with their
times; prints the two rows as JSON.

    python3 port_tools/giou_check.py   # from the repo root, on a GPU
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

cs.log(cs.gpu_name_and_power())
cs.build_kernels()
dev = torch.device("cuda", 0)
print(json.dumps(cs.giou_kernel_rows(dev, torch.Generator(device=dev).manual_seed(0))))
