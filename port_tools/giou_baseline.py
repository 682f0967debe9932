"""Time the GIoU loss of the checkout given as the first argument, on one GPU,
at the FCOS step's 343,776 rows: the forward kernel alone and the loss with
its backward as fcos_supervised_losses runs them (giou_loss(...).backward()).

    python3 port_tools/giou_baseline.py <checkout>

For the forward kernel: back-to-back ms (chip_smoke.py's median_ms), device ms
per call (torch.profiler) and host ms per call. For the loss forward, and the
loss forward with its backward: device ms per call and the device kernels
launched per call, by name. The port's GIoU wrapper is giou_cuda (CUDA
forward and backward) or, in older checkouts, giou_triton (a Triton forward,
autograd of the plain formula backward). Run it on an older checkout (a `git
archive` of a parent commit) and on this one in turns to compare. Prints one
JSON line.
"""
import importlib
import importlib.util
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location("smoke", os.path.join(here, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from ubteacher_tpu_torch.ops.kernels import build  # noqa: E402

try:
    giou = importlib.import_module("ubteacher_tpu_torch.ops.kernels.giou_cuda")
except ImportError:
    giou = importlib.import_module("ubteacher_tpu_torch.ops.kernels.giou_triton")

cs.log(cs.gpu_name_and_power())
build.build_all()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
p = torch.rand((cs.GIOU_N, 4), generator=gen, device=dev) * 12.0 + 0.05
q = torch.rand((cs.GIOU_N, 4), generator=gen, device=dev) * 12.0 + 0.05
w = torch.rand((cs.GIOU_N,), generator=gen, device=dev)


def per_call(fn, calls=20):
    """{device row: (ms, launches)} per call of fn, after one untimed call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / calls / 1e3, e.count / calls) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0}


def loss_forward():
    return giou.giou_loss(p.detach().requires_grad_(True), q, w)


def loss_backward():
    leaf = p.detach().requires_grad_(True)
    giou.giou_loss(leaf, q, w).backward()
    return leaf.grad


def kernel():
    return giou.giou_rows_kernel(p, q, w)


out = {"tree": tree, "wrapper": giou.__name__.rsplit(".", 1)[-1], "rows": cs.GIOU_N,
       "fwd_kernel_ms": cs.median_ms(kernel), "fwd_kernel_host_ms": cs.host_ms(kernel)}
fwd_split = per_call(kernel)
out["fwd_kernel_device_ms"] = sum(ms for ms, _ in fwd_split.values())
for name, fn in (("loss_fwd", loss_forward), ("loss_fwd_bwd", loss_backward)):
    split = per_call(fn)
    out[f"{name}_device_ms"] = sum(ms for ms, _ in split.values())
    out[f"{name}_launches"] = sum(n for _, n in split.values())
    out[f"{name}_ms"] = cs.median_ms(fn)
    cs.log(f"{name}: " + "; ".join(f"{n:.0f} x {k[:70]} {ms:.4f} ms" for k, (ms, n) in
                                   sorted(split.items(), key=lambda kv: -kv[1][0])))
out["bwd_device_ms"] = out["loss_fwd_bwd_device_ms"] - out["loss_fwd_device_ms"]
out["bwd_launches"] = out["loss_fwd_bwd_launches"] - out["loss_fwd_launches"]
print(json.dumps(out), flush=True)
