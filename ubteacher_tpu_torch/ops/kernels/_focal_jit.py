"""Triton sources of the focal-loss kernels (see focal_triton.py).

Imports triton at module level: import this module only where a kernel is
launched on a CUDA tensor.
"""

import triton
import triton.language as tl

try:  # Triton >= 3.1
    from triton.language.extra import libdevice
except ImportError:  # Triton 3.0 keeps libdevice under the cuda backend
    from triton.language.extra.cuda import libdevice


@triton.jit
def _pow(x, GAMMA: tl.constexpr):
    if GAMMA == 2.0:
        return x * x
    elif GAMMA == 1.0:
        return x
    else:
        return libdevice.pow(x, GAMMA)


@triton.jit
def focal_fwd_kernel(x_ptr, t_ptr, out_ptr, n, alpha,
                     GAMMA: tl.constexpr, USE_ALPHA: tl.constexpr,
                     BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    t = tl.load(t_ptr + offs, mask=mask, other=0.0)
    p = tl.sigmoid(x)
    ce = tl.maximum(x, 0.0) - x * t + libdevice.log1p(tl.exp(-tl.abs(x)))
    p_t = p * t + (1.0 - p) * (1.0 - t)
    loss = ce * _pow(1.0 - p_t, GAMMA)
    if USE_ALPHA:
        loss = (alpha * t + (1.0 - alpha) * (1.0 - t)) * loss
    tl.store(out_ptr + offs, loss, mask=mask)


@triton.jit
def focal_bwd_kernel(x_ptr, t_ptr, g_ptr, dx_ptr, n, alpha,
                     GAMMA: tl.constexpr, USE_ALPHA: tl.constexpr,
                     BLOCK: tl.constexpr):
    # loss = a_t (1 - p_t)^g ce;  d ce/dx = p - t;  d p_t/dx = p (1-p) (2t-1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    t = tl.load(t_ptr + offs, mask=mask, other=0.0)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0)
    p = tl.sigmoid(x)
    ce = tl.maximum(x, 0.0) - x * t + libdevice.log1p(tl.exp(-tl.abs(x)))
    p_t = p * t + (1.0 - p) * (1.0 - t)
    one_m = tl.maximum(1.0 - p_t, 1e-20)
    term = _pow(one_m, GAMMA) * (p - t) - GAMMA * _pow(one_m, GAMMA - 1.0) * p * (
        1.0 - p
    ) * (2.0 * t - 1.0) * ce
    if USE_ALPHA:
        term = (alpha * t + (1.0 - alpha) * (1.0 - t)) * term
    tl.store(dx_ptr + offs, term * g, mask=mask)
