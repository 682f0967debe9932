"""Build variants of the fused stem (csrc/stem.cu) or the anchor matcher
(csrc/matcher.cu), one nvcc each, all started together, and time each
through its wrapper in one chip call, with its agreement with the plain
version: the stem in bf16 at 8 x 800 x 1344 read from an NCHW batch, the
matcher at chip_smoke.py's kernel-phase gts and at the R-CNN step's mix
(mismatched entries must be 0).

    python3 port_tools/kernel_variants.py port_tools/kernel_variants/<set>.json

A set maps a variant name to {"kernel": "stem" or "matcher", "source": a
path (default the kernel's csrc file), "replace": [[old, new], ...]}. A
variant keeps the kernel's C interface; a replacement missing from its
source stops the script. Variants that remove a phase give a breakdown.
The sets under port_tools/kernel_variants/ record what was run while the
current designs were tuned: each applies to the sources as they stood
then, and a "source" under _scratch/ (git-ignored) was an earlier design
copied aside for a side-by-side timing, not kept.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.ops.kernels import build, matcher_cuda, stem_cuda  # noqa: E402
from ubteacher_tpu_torch.ops.stem import stem_conv_pool_plain  # noqa: E402

MODULES = {"stem": stem_cuda, "matcher": matcher_cuda}
OUT = "ubteacher_tpu_torch/_build/variants"


def build_variants(spec):
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, v in spec.items():
        s = open(v.get("source", build.source_path(v["kernel"]))).read()
        for a, b in v.get("replace", []):
            if a not in s:
                raise SystemExit(f"{name}: {a!r} not in the source")
            s = s.replace(a, b)
        path = f"{OUT}/{name}.cu"
        open(path, "w").write(s)
        cmd = [build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
               "-shared", "-Xcompiler", "-fPIC", "-o", f"{OUT}/lib{name}.so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            print(name, "BUILD FAILED", err[-3000:], flush=True)
            continue
        print(name, [l.strip() for l in err.splitlines() if "registers" in l or "spill" in l], flush=True)
        libs[name] = os.path.abspath(f"{OUT}/lib{name}.so")
    return libs


def main():
    spec = json.loads(open(sys.argv[1]).read())
    libs = build_variants(spec)
    print(cs.gpu_name_and_power(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cudnn.allow_tf32 = False
    h, w = cs.EVAL_CANVAS
    x = (torch.randn((cs.EVAL_BATCH, 3, h, w), generator=gen, device=dev) * 50).permute(0, 2, 3, 1)
    kernel = torch.randn((7, 7, 3, 64), generator=gen, device=dev) * 0.1
    scale = torch.rand((64,), generator=gen, device=dev) * 1.5 + 0.5
    bias = torch.randn((64,), generator=gen, device=dev)
    ref16 = stem_conv_pool_plain(x, kernel, scale, bias, torch.bfloat16).float()
    tol16 = 2 * cs.bf16_ulp(ref16.abs() + bias.bfloat16().float().abs())
    anchors = cs.rcnn_anchors(cs.CANVAS, dev)["anchors"]
    gt, mask = cs.matcher_gt(gen, dev, anchors)
    step = mask.clone()
    step[2 * cs.BATCH_LABEL:] = True
    sets = {"kernel phase": (gt, mask), "step mix": (gt, step.contiguous())}
    refs = {k: matcher_cuda.match_anchors_plain(anchors, *v) for k, v in sets.items()}
    for name, path in libs.items():
        kind = spec[name]["kernel"]
        mod = MODULES[kind]
        lib = mod.bind(path)
        mod._library = lambda lib=lib: lib
        if kind == "stem":
            def call():
                return stem_cuda.stem_conv_pool_kernel(x, kernel, scale, bias, torch.bfloat16)

            err = (call().float() - ref16).abs()
            bad = int((err > tol16).sum())
            print(f"{name}: {cs.median_ms(call):.4f} ms, max abs err {float(err.max()):.3g}, "
                  f"{bad} beyond two bf16 ulps", flush=True)
        else:
            parts = []
            for k, (g, m) in sets.items():
                idx, lab = matcher_cuda.match_anchors_kernel(anchors, g, m)
                wrong = int((idx != refs[k][0]).sum() + (lab != refs[k][1]).sum())
                ms = cs.median_ms(lambda g=g, m=m: matcher_cuda.match_anchors_kernel(anchors, g, m))
                parts.append(f"{k} {ms:.4f} ms ({wrong} mismatched)")
            print(f"{name}: " + ", ".join(parts), flush=True)


if __name__ == "__main__":
    main()
