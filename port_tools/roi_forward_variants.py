"""Build variants of csrc/roi_align.cu, each a list of text replacements
read from a JSON file ({name: [[old, new], ...]}), with one nvcc per variant
started together, and time each variant's forward through ctypes at the main
path's shapes (bf16 and float32), with its error against the plain version.

    python3 port_tools/roi_forward_variants.py port_tools/roi_forward_variants/v3.json

The JSON files hold the sets measured while the forward was designed; each
applies to the source as it stood when it was run (v1 and v2 to earlier
states of the staging code), so a replacement missing from the current
source stops the script.
"""
import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.ops.kernels import build, roi_align_cuda  # noqa: E402
from ubteacher_tpu_torch.ops.roi_align import assign_levels  # noqa: E402

SRC = open("ubteacher_tpu_torch/csrc/roi_align.cu").read()
VARIANTS = {k: v for k, v in __import__("json").loads(open(sys.argv[1]).read()).items()}
out_dir = "ubteacher_tpu_torch/_build/variants"
os.makedirs(out_dir, exist_ok=True)
procs = {}
for name, reps in VARIANTS.items():
    s = SRC
    for a, b in reps:
        if a not in s:
            raise SystemExit(f"{name}: {a!r} not in the source")
        s = s.replace(a, b)
    path = f"{out_dir}/{name}.cu"
    open(path, "w").write(s)
    cmd = [build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", f"{out_dir}/lib{name}.so", path]
    procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
libs = {}
for name, p in procs.items():
    _, err = p.communicate()
    if p.returncode:
        print(name, "BUILD FAILED", err[-3000:], flush=True)
        continue
    fwd = [l for l in err.splitlines() if "registers" in l or "spill" in l]
    print(name, fwd[-8:], flush=True)
    lib = ctypes.CDLL(os.path.abspath(f"{out_dir}/lib{name}.so"))
    pp, i = ctypes.c_void_p, ctypes.c_int
    lib.ubt_roi_align_forward.argtypes = [i, ctypes.POINTER(roi_align_cuda._Levels), pp, pp, i, i, i, i, i, pp, pp]
    libs[name] = lib

print(cs.gpu_name_and_power(), flush=True)
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
b, c, p, r = cs.RCNN_STUDENT, 256, 7, cs.RCNN_ROIS
h, w = cs.CANVAS
feats = [torch.randn((b, c, h >> lv, w >> lv), generator=gen, device=dev) for lv in (2, 3, 4, 5)]
scales = [1.0 / 2**lv for lv in (2, 3, 4, 5)]
boxes = cs.rcnn_rois(gen, dev, b, r)
level = (assign_levels(boxes, 2, 5) - 2).contiguous()
f16 = [f.bfloat16() for f in feats]
ref = {n: roi_align_cuda.roi_align_plain(fs, boxes, level, r, scales, p, 0).float() for n, fs in (("bf16", f16), ("f32", feats))}
for name, lib in libs.items():
    for dn, fs in (("bf16", f16), ("f32", feats)):
        out = torch.empty((b * r, p, p, c), dtype=fs[0].dtype, device=dev)
        lv = roi_align_cuda._levels(fs, scales)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            e = lib.ubt_roi_align_forward(int(dn == "bf16"), ctypes.byref(lv), boxes.data_ptr(), level.data_ptr(),
                                          b * r, r, c, p, 0, out.data_ptr(), stream)
            assert e == 0, e

        call()
        torch.cuda.synchronize()
        err = float((out.float() - ref[dn]).abs().max())
        print(f"{name} {dn}: {cs.median_ms(call):.4f} ms, max abs err {err:.3g}", flush=True)
