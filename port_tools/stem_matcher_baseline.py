"""Time the fused stem and the anchor matcher of the checkout given as the
first argument, on one GPU, at chip_smoke.py's shapes:

    python3 port_tools/stem_matcher_baseline.py <checkout>

The stem in bf16 at 8 x 800 x 1344: as the model calls it (the ResNet
"pallas" stem from an NCHW batch under bf16 autocast, whatever layout
change that checkout makes on the way) and the kernel alone on a contiguous
NHWC copy (the layout every checkout takes); the matcher at the kernel
phase's gts and at the R-CNN step's mix (images 16-23 with all 100 slots
valid). Times are chip_smoke.py's median_ms. Run it on a `git archive` of
a parent commit and on this checkout in turns (parent, this, this, parent)
in one call to compare.
"""
import os
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.modeling.resnet import ResNet  # noqa: E402
from ubteacher_tpu_torch.ops.kernels import build, matcher_cuda, stem_cuda  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print("tree", tree, flush=True)
build.build_all(("stem", "matcher"))
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
h, w = cs.EVAL_CANVAS
x_nchw = torch.randn((cs.EVAL_BATCH, 3, h, w), generator=gen, device=dev) * 50
nhwc = x_nchw.permute(0, 2, 3, 1).contiguous()
kernel = torch.randn((7, 7, 3, 64), generator=gen, device=dev) * 0.1
scale = torch.rand((64,), generator=gen, device=dev) * 1.5 + 0.5
bias = torch.randn((64,), generator=gen, device=dev)
net = ResNet(depth=18, out_features=("res2",), stem_mode="pallas").to(dev)
with torch.no_grad():
    net.stem_conv1.weight.copy_(kernel.permute(3, 2, 0, 1))
    net.stem_conv1_norm.scale.copy_(scale)
    net.stem_conv1_norm.bias.copy_(bias)


def call():
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        return net.stem(x_nchw)


print("stem as the model calls it, bf16 ms", cs.median_ms(call), flush=True)
print("stem kernel on NHWC, bf16 ms",
      cs.median_ms(lambda: stem_cuda.stem_conv_pool_kernel(nhwc, kernel, scale, bias, torch.bfloat16)), flush=True)
anchors = cs.rcnn_anchors(cs.CANVAS, dev)["anchors"]
gt, mask = cs.matcher_gt(gen, dev, anchors)
step = mask.clone()
step[2 * cs.BATCH_LABEL:] = True
for name, m in (("kernel phase", mask), ("step mix", step.contiguous())):
    print(f"matcher {name} ms", cs.median_ms(lambda m=m: matcher_cuda.match_anchors_kernel(anchors, gt, m)), flush=True)
