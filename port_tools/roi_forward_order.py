"""Does the order of an image's rois change the ROIAlign forward's time?
Permutes the rois within each image (the kernel takes a roi's image from its
index) by level, by level and position, and times the kernel on each order,
bf16 and float32, on uniform and clustered rois.

    python3 port_tools/roi_forward_order.py   # from the repo root, on a GPU
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.ops.kernels import roi_align_cuda  # noqa: E402
from ubteacher_tpu_torch.ops.roi_align import assign_levels  # noqa: E402

cs.log(cs.gpu_name_and_power())
cs.build_kernels()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
b, c, p, r = cs.RCNN_STUDENT, 256, 7, cs.RCNN_ROIS
h, w = cs.CANVAS
feats = [torch.randn((b, c, h >> lv, w >> lv), generator=gen, device=dev) for lv in (2, 3, 4, 5)]
f16 = [f.bfloat16() for f in feats]
scales = [1.0 / 2**lv for lv in (2, 3, 4, 5)]
for name, boxes in (("uniform", cs.rcnn_rois(gen, dev, b, r)), ("clustered", cs.clustered_rois(gen, dev, b, r))):
    level = (assign_levels(boxes, 2, 5) - 2).contiguous()
    img = torch.arange(b * r, device=dev) // r
    yc = ((boxes[:, 1] + boxes[:, 3]) / 2 * torch.tensor(scales, device=dev)[level.long()]).long()
    xc = ((boxes[:, 0] + boxes[:, 2]) / 2 * torch.tensor(scales, device=dev)[level.long()]).long()
    keys = {
        "index": img * 0,
        "level": level.long(),
        "level,y": level.long() * 4096 + yc,
        "level,y/8,x": (level.long() * 4096 + yc // 8) * 4096 + xc,
        "level desc,y": (3 - level.long()) * 4096 + yc,
    }
    for kname, key in keys.items():
        order = torch.sort(img * 2**40 + key, stable=True)[1]
        bx, lv = boxes[order].contiguous(), level[order].contiguous()
        ms = cs.median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(f16, bx, lv, r, scales, p, 0))
        ms32 = cs.median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(feats, bx, lv, r, scales, p, 0))
        cs.log(f"{name} order by {kname}: bf16 {ms:.4f} ms, f32 {ms32:.4f} ms")
