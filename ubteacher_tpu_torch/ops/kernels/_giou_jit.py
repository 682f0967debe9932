"""Triton source of the GIoU-loss kernel (see giou_triton.py).

Imports triton at module level: import this module only where the kernel is
launched on a CUDA tensor.
"""

import triton
import triton.language as tl


@triton.jit
def giou_fwd_kernel(p_ptr, t_ptr, w_ptr, out_ptr, n, BLOCK: tl.constexpr):
    rows = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = rows < n
    base = rows * 4
    pl_ = tl.load(p_ptr + base + 0, mask=mask, other=1.0)
    pt_ = tl.load(p_ptr + base + 1, mask=mask, other=1.0)
    pr_ = tl.load(p_ptr + base + 2, mask=mask, other=1.0)
    pb_ = tl.load(p_ptr + base + 3, mask=mask, other=1.0)
    tl_ = tl.load(t_ptr + base + 0, mask=mask, other=1.0)
    tt_ = tl.load(t_ptr + base + 1, mask=mask, other=1.0)
    tr_ = tl.load(t_ptr + base + 2, mask=mask, other=1.0)
    tb_ = tl.load(t_ptr + base + 3, mask=mask, other=1.0)
    w = tl.load(w_ptr + rows, mask=mask, other=0.0)

    target_area = (tl_ + tr_) * (tt_ + tb_)
    pred_area = (pl_ + pr_) * (pt_ + pb_)
    w_i = tl.minimum(pl_, tl_) + tl.minimum(pr_, tr_)
    h_i = tl.minimum(pb_, tb_) + tl.minimum(pt_, tt_)
    g_w = tl.maximum(pl_, tl_) + tl.maximum(pr_, tr_)
    g_h = tl.maximum(pb_, tb_) + tl.maximum(pt_, tt_)
    ac = g_w * g_h
    inter = w_i * h_i
    union = target_area + pred_area - inter
    ious = (inter + 1.0) / (union + 1.0)
    gious = ious - (ac - union) / tl.where(ac == 0.0, 1.0, ac)
    tl.store(out_ptr + rows, (1.0 - gious) * w, mask=mask)
