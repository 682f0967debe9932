"""Time the NMS kernel (its mask and sweep kernels apart) and the ROIAlign
forward (alone, and with the box head's reshape to (N, P * P * C)) of the
checkout given as the first argument, on one GPU.

    python3 port_tools/kernel_baseline.py <checkout>

NMS at the FCOS shape (chip_smoke.py's clustered 8 x 5,000 candidates,
t 0.6) and at the student RPN's shape (120 rows x 2,000 proposal-like boxes,
t 0.7); the forward over p2-p5 of 24 images, 256 channels, 512 rois per
image, bf16 and float32. Times are chip_smoke.py's median_ms; the split is
torch.profiler's device time per kernel over 20 calls. Run it on an older
checkout (a `git archive` of a parent commit) and on this one to compare.
"""
import math
import os
import statistics
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.ops.kernels import build, nms_cuda, roi_align_cuda  # noqa: E402
from ubteacher_tpu_torch.ops.roi_align import assign_levels  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print("tree", tree, flush=True)
for name, (_, rep, sec) in build.build_all().items():
    print(name, f"{sec:.1f}s", [l.strip() for l in rep.splitlines() if "registers" in l], flush=True)
dev = torch.device("cuda", 0)


def rpn_inputs(gen, b=24, levels=5, k=2000, t=0.7):
    h, w = cs.CANVAS
    rows = []
    nv = []
    for lv in range(levels):
        stride = 4 * 2**lv
        n = min(k, (h // stride) * (w // stride) * 3 if lv == 4 else k)
        obj = 20
        ctr_o = torch.rand((b, obj, 2), generator=gen, device=dev) * torch.tensor([w, h], device=dev)
        pick = torch.randint(0, obj, (b, k), generator=gen, device=dev)
        size = 32 * 2**lv * torch.exp(torch.randn((b, k), generator=gen, device=dev) * 0.3)
        ctr = torch.gather(ctr_o, 1, pick[..., None].expand(-1, -1, 2))
        ctr = ctr + torch.randn((b, k, 2), generator=gen, device=dev) * 0.15 * size[..., None]
        ratio = torch.exp((torch.rand((b, k), generator=gen, device=dev) * 2 - 1) * math.log(2))
        half = torch.stack([size * ratio.sqrt(), size / ratio.sqrt()], -1) / 2
        bx = torch.cat([ctr - half, ctr + half], -1)
        bx = torch.minimum(bx.clamp_min(0), torch.tensor([w, h, w, h], dtype=torch.float32, device=dev))
        rows.append(bx)
        nv.append(torch.full((b,), n, dtype=torch.int32, device=dev))
    boxes = torch.stack(rows, 1).reshape(b * levels, k, 4).contiguous()
    nvalid = torch.stack(nv, 1).reshape(-1).contiguous()
    return boxes, nvalid


def kernel_split(fn, n=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU and e.self_device_time_total > 0:
            out[e.key[:60]] = e.self_device_time_total / n / 1e3
    return out


gen = torch.Generator(device=dev).manual_seed(0)
sb, nv = cs.nms_inputs(*cs.clustered_boxes(gen, dev))
for label, (bx, nvalid, t) in (("fcos 8x5000 t0.6", (sb, nv, 0.6)), ("rpn 120x2000 t0.7", (*rpn_inputs(gen), 0.7))):
    got = nms_cuda.nms_sorted_keep_kernel(bx, nvalid, t)
    ref = nms_cuda.nms_sorted_keep_plain(bx, nvalid, t)
    torch.cuda.synchronize()
    print(label, "kept", int(got.sum()), "of", int(nvalid.sum()), "mismatch", int((got != ref).sum()), flush=True)
    print(label, "ms", cs.median_ms(lambda: nms_cuda.nms_sorted_keep_kernel(bx, nvalid, t)), flush=True)
    print(label, "split", kernel_split(lambda: nms_cuda.nms_sorted_keep_kernel(bx, nvalid, t)), flush=True)

b, c, p, r = cs.RCNN_STUDENT, 256, 7, cs.RCNN_ROIS
h, w = cs.CANVAS
feats = [torch.randn((b, c, h >> lv, w >> lv), generator=gen, device=dev) for lv in (2, 3, 4, 5)]
scales = [1.0 / 2**lv for lv in (2, 3, 4, 5)]
boxes = cs.rcnn_rois(gen, dev, b, r)
level = (assign_levels(boxes, 2, 5) - 2).contiguous()
args = (boxes, level, r, scales, p, 0)
f16 = [f.bfloat16() for f in feats]
for name, fs in (("bf16", f16), ("f32", feats)):
    print("roi fwd", name, cs.median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(fs, *args)), flush=True)
    print("roi fwd+reshape", name,
          cs.median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(fs, *args).reshape(b * r, -1)), flush=True)
    print("roi fwd split", name,
          kernel_split(lambda: roi_align_cuda.roi_align_forward_kernel(fs, *args).reshape(b * r, -1)), flush=True)
cb = cs.clustered_rois(gen, dev, b, r)
cl = (assign_levels(cb, 2, 5) - 2).contiguous()
print("roi fwd clustered bf16", cs.median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(f16, cb, cl, r, scales, p, 0)))
