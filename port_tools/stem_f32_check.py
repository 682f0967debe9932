"""The fused stem's float32 path against references of different accuracy,
at chip_smoke.py's kernel-phase inputs (the FCOS and R-CNN kernel rows run
first, as in chip_smoke.py, so the card's memory is in the same state):
the plain version with cuDNN (on the NCHW view and on a contiguous NHWC
copy), the plain version with cuDNN disabled (PyTorch's own im2col + GEMM),
and the float64 conv (the truth). Prints, for each pair, the max abs error
and the count beyond rtol 1e-5 / atol 1e-4.

    python3 port_tools/stem_f32_check.py   # from the repo root, on a GPU
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.ops.kernels import stem_cuda  # noqa: E402
from ubteacher_tpu_torch.ops.stem import stem_conv_pool_plain  # noqa: E402


def compare(name, a, b):
    err = (a.double() - b.double()).abs()
    beyond = int((err > 1e-4 + 1e-5 * b.double().abs()).sum())
    print(f"  {name}: max abs err {float(err.max()):.3g}, beyond tolerance {beyond}", flush=True)


cs.log(cs.gpu_name_and_power())
cs.build_kernels()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
cs.fcos_kernel_rows(dev, gen)
cs.rcnn_kernel_rows(dev, gen)
torch.backends.cudnn.allow_tf32 = False
kernel = torch.randn((7, 7, 3, 64), generator=gen, device=dev) * 0.1
scale = torch.rand((64,), generator=gen, device=dev) * 1.5 + 0.5
bias = torch.randn((64,), generator=gen, device=dev)
for orient, (h, w) in (("landscape", cs.EVAL_CANVAS), ("portrait", cs.EVAL_CANVAS[::-1])):
    x = (torch.randn((cs.EVAL_BATCH, 3, h, w), generator=gen, device=dev) * 50).permute(0, 2, 3, 1)
    got = stem_cuda.stem_conv_pool_kernel(x, kernel, scale, bias, torch.float32)
    ref_view = stem_conv_pool_plain(x, kernel, scale, bias, torch.float32)
    ref_nhwc = stem_conv_pool_plain(x.contiguous(), kernel, scale, bias, torch.float32)
    with torch.backends.cudnn.flags(enabled=False):
        ref_native = stem_conv_pool_plain(x, kernel, scale, bias, torch.float32)
    truth = cs.stem_truth64(x, kernel, scale, bias)
    print(orient, flush=True)
    for name, r in (("plain cuDNN, NCHW view", ref_view), ("plain cuDNN, NHWC copy", ref_nhwc),
                    ("plain without cuDNN", ref_native), ("float64 truth", truth)):
        compare(f"kernel vs {name}", got, r)
    for name, r in (("plain cuDNN, NCHW view", ref_view), ("plain cuDNN, NHWC copy", ref_nhwc),
                    ("plain without cuDNN", ref_native)):
        compare(f"{name} vs float64 truth", r, truth)
    del x, got, ref_view, ref_nhwc, ref_native, truth
    torch.cuda.empty_cache()
