"""Build the kernels and run chip_smoke.py's fused-stem and anchor-matcher
rows alone (checks against the plain versions, edge cases, timings), without
the other kernels and the train and eval phases; prints the two rows as JSON.

    python3 port_tools/stem_matcher_check.py   # from the repo root, on a GPU
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

cs.log(cs.gpu_name_and_power())
cs.build_kernels()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
rows = []
for fn in (cs.matcher_row, cs.stem_kernel_rows):
    t0 = time.perf_counter()
    out = fn(dev, gen)
    rows += out if isinstance(out, list) else [out]
    cs.log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
print(json.dumps(rows))
