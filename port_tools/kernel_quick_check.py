"""Build the kernels, check NMS and the ROIAlign forward against their plain
versions with chip_smoke.py's checks (edge cases included), and time both,
without the slow plain timings and the train and eval phases.

    python3 port_tools/kernel_quick_check.py   # from the repo root, on a GPU
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.ops.kernels import nms_cuda, roi_align_cuda  # noqa: E402
from ubteacher_tpu_torch.ops.roi_align import assign_levels  # noqa: E402

cs.log(cs.gpu_name_and_power())
cs.build_kernels()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
t0 = time.perf_counter()
for name, sb, nv, t in cs.nms_edge_cases(gen, dev):
    cs.check_nms(name, sb, nv, t)
sboxes, nvalid = cs.nms_inputs(*cs.clustered_boxes(gen, dev))
cs.check_nms("FCOS shape", sboxes, nvalid, cs.NMS_T)
rb, rv = cs.rpn_nms_inputs(gen, dev)
cs.check_nms("RPN shape", rb, rv, cs.NMS_RPN_T)
cs.assert_no_host_sync("nms", lambda: nms_cuda.nms_sorted_keep_kernel(sboxes, nvalid, cs.NMS_T))
for name, (sb, nv, t) in (("FCOS", (sboxes, nvalid, cs.NMS_T)), ("RPN", (rb, rv, cs.NMS_RPN_T))):
    cs.log(name, "ms", cs.median_ms(lambda: nms_cuda.nms_sorted_keep_kernel(sb, nv, t)),
           cs.kernel_split_ms(lambda: nms_cuda.nms_sorted_keep_kernel(sb, nv, t)))

b, c, p, r = cs.RCNN_STUDENT, 256, 7, cs.RCNN_ROIS
h, w = cs.CANVAS
feats = [torch.randn((b, c, h >> lv, w >> lv), generator=gen, device=dev) for lv in (2, 3, 4, 5)]
scales = [1.0 / 2**lv for lv in (2, 3, 4, 5)]
boxes = cs.rcnn_rois(gen, dev, b, r)
level = (assign_levels(boxes, 2, 5) - 2).contiguous()
args = (boxes, level, r, scales, p, 0)
f16 = [f.bfloat16() for f in feats]
# one launch first, synchronised, before any comparison
out = roi_align_cuda.roi_align_forward_kernel(f16, *args)
torch.cuda.synchronize()
cs.log("first forward launch ok", tuple(out.shape), out.is_contiguous())
del out
cs.check_roi_fwd("main", feats, f16, args)
cs.assert_no_host_sync("roi_align_fwd", lambda: roi_align_cuda.roi_align_forward_kernel(f16, *args))
cs.check_roi_fwd_edges(dev, gen, feats, f16, scales)
for name, fs in (("bf16", f16), ("f32", feats)):
    cs.log("roi fwd", name, cs.median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(fs, *args)))
cb = cs.clustered_rois(gen, dev, b, r)
cl = (assign_levels(cb, 2, 5) - 2).contiguous()
cs.log("roi fwd clustered bf16", cs.median_ms(lambda: roi_align_cuda.roi_align_forward_kernel(f16, cb, cl, r, scales, p, 0)))
cs.log("seconds", time.perf_counter() - t0)
