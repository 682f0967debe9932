"""On-device strong photometric augmentation (PyTorch port of the strong part
of ubteacher_tpu.data.augment, :223-410).

SimCLR-style color jitter (p=0.8) -> random grayscale (p=0.2) -> Gaussian
blur (p=0.5, sigma ~ U[0.1, 2]) -> 3x random erasing with normal-noise fill
(reference build_strong_augmentation, data/detection_utils.py:8-46). Geometry
is untouched, so the weak image's boxes stay valid.

The pipeline is split in two: `draw_strong_params` draws every random number
from a torch.Generator, and `apply_strong` applies given draws to the images,
so a test can hand the JAX package's draws to the port. The apply step runs in
float32 (the JAX package computes it in bfloat16).

Deviations from torchvision, shared with the JAX package: the ColorJitter
sub-ops apply in fixed order (brightness, contrast, saturation, hue), and
RandomErasing samples one candidate rectangle instead of ten tries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

# (p, scale, ratio) of the three RandomErasing passes (detection_utils.py:29-43)
ERASE_PASSES: Tuple[Tuple[float, Tuple[float, float], Tuple[float, float]], ...] = (
    (0.7, (0.05, 0.2), (0.3, 3.3)),
    (0.5, (0.02, 0.2), (0.1, 6.0)),
    (0.3, (0.02, 0.2), (0.05, 8.0)),
)
JITTER = (0.4, 0.4, 0.4, 0.1)  # brightness, contrast, saturation, hue
BLUR_TAPS = 9


@dataclasses.dataclass
class StrongAugParams:
    """Per-image draws of the strong pipeline for a (B, H, W, 3) batch.

    jitter (B, 4) brightness/contrast/saturation factors and hue shift;
    apply_jitter, apply_gray, apply_blur (B,) bool; sigma (B,);
    erase_box (B, 3, 4) int64 (y0, x0, h, w) per erasing pass;
    apply_erase (B, 3) bool; erase_noise (B, 3, H, W, 3) fill values in [0, 1].
    """

    jitter: torch.Tensor
    apply_jitter: torch.Tensor
    apply_gray: torch.Tensor
    sigma: torch.Tensor
    apply_blur: torch.Tensor
    erase_box: torch.Tensor
    apply_erase: torch.Tensor
    erase_noise: torch.Tensor


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def draw_strong_params(
    batch: int, height: int, width: int, generator: torch.Generator
) -> StrongAugParams:
    """Draw the strong pipeline's parameters on the generator's device."""
    dev = generator.device
    b, br, co, sa, hu = batch, *JITTER
    jitter = torch.stack(
        [
            _uniform((b,), 1 - br, 1 + br, generator, dev),
            _uniform((b,), 1 - co, 1 + co, generator, dev),
            _uniform((b,), 1 - sa, 1 + sa, generator, dev),
            _uniform((b,), -hu, hu, generator, dev),
        ],
        dim=-1,
    )
    apply_jitter = torch.rand((b,), generator=generator, device=dev) < 0.8
    apply_gray = torch.rand((b,), generator=generator, device=dev) < 0.2
    sigma = _uniform((b,), 0.1, 2.0, generator, dev)
    apply_blur = torch.rand((b,), generator=generator, device=dev) < 0.5
    boxes, applies = [], []
    area = height * width
    for p, scale, ratio in ERASE_PASSES:
        target = _uniform((b,), scale[0], scale[1], generator, dev) * area
        r = torch.exp(_uniform((b,), math.log(ratio[0]), math.log(ratio[1]), generator, dev))
        eh = torch.clamp(torch.sqrt(target * r), 1, height - 1).long()
        ew = torch.clamp(torch.sqrt(target / r), 1, width - 1).long()
        y0 = (torch.rand((b,), generator=generator, device=dev) * (height - eh)).long()
        x0 = (torch.rand((b,), generator=generator, device=dev) * (width - ew)).long()
        boxes.append(torch.stack([y0, x0, eh, ew], dim=-1))
        applies.append(torch.rand((b,), generator=generator, device=dev) < p)
    noise = torch.randn((b, len(ERASE_PASSES), height, width, 3), generator=generator, device=dev)
    return StrongAugParams(
        jitter=jitter,
        apply_jitter=apply_jitter,
        apply_gray=apply_gray,
        sigma=sigma,
        apply_blur=apply_blur,
        erase_box=torch.stack(boxes, dim=1),
        apply_erase=torch.stack(applies, dim=1),
        erase_noise=torch.clamp(noise, 0.0, 1.0),
    )


# luma weights in BGR channel order
_LUMA_BGR = (0.114, 0.587, 0.2989)


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1) luma."""
    luma = torch.tensor(_LUMA_BGR, dtype=x.dtype, device=x.device)
    return (x * luma).sum(-1, keepdim=True)


def _to_hsv(x: torch.Tensor):
    """x in [0, 1], BGR -> (h, s, v)."""
    b, g, r = x.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe_d = torch.where(d == 0, 1.0, d)
    hr = torch.remainder((g - b) / safe_d, 6.0)
    hg = (b - r) / safe_d + 2.0
    hb = (r - g) / safe_d + 4.0
    hue = torch.where(mx == r, hr, torch.where(mx == g, hg, hb)) / 6.0
    hue = torch.where(d == 0, 0.0, hue)
    sat = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return hue, sat, mx


def _from_hsv(hue: torch.Tensor, sat: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """-> BGR in [0, 1]."""
    h6 = hue * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    i = torch.remainder(i, 6.0)

    def select(values: Sequence[torch.Tensor]) -> torch.Tensor:
        out = values[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out

    r = select([val, q, p, p, t, val])
    g = select([t, val, val, q, p, p])
    b = select([p, p, t, val, val, q])
    return torch.stack([b, g, r], dim=-1)


def _color_jitter(x: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) in [0, 1]; jitter (B, 4)."""
    fb, fc, fs, fh = (jitter[:, k].reshape(-1, 1, 1, 1) for k in range(4))
    x = x * fb
    gray = _gray(x)
    x = x * fc + gray.mean(dim=(1, 2, 3), keepdim=True) * (1 - fc)
    x = x * fs + gray * (1 - fs)
    x = torch.clamp(x, 0.0, 1.0)
    hue, sat, val = _to_hsv(x)
    x = _from_hsv(torch.remainder(hue + fh[..., 0], 1.0), sat, val)
    return torch.clamp(x, 0.0, 1.0)


def _gaussian_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 9-tap Gaussian blur with per-image sigma and edge (replicate)
    padding, along W then along H. x (B, H, W, 3)."""
    half = BLUR_TAPS // 2
    d = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-(d**2)[None, :] / (2.0 * torch.clamp(sigma, min=1e-3)[:, None] ** 2))
    k = (k / k.sum(-1, keepdim=True)).to(x.dtype)  # (B, taps)

    def along(y: torch.Tensor, dim: int) -> torch.Tensor:
        n = y.shape[dim]
        idx = torch.arange(n, device=y.device)
        out = torch.zeros_like(y)
        for t in range(-half, half + 1):
            src = torch.clamp(idx + t, 0, n - 1)
            out = out + k[:, t + half].reshape(-1, 1, 1, 1) * torch.index_select(y, dim, src)
        return out

    return along(along(x, 2), 1)


def apply_strong(images: torch.Tensor, params: StrongAugParams) -> torch.Tensor:
    """Apply drawn strong augmentation to (B, H, W, 3) float BGR in [0, 255];
    returns float32 in [0, 255]."""
    x = images.float() / 255.0
    x = torch.where(params.apply_jitter.reshape(-1, 1, 1, 1), _color_jitter(x, params.jitter), x)
    x = torch.where(params.apply_gray.reshape(-1, 1, 1, 1), _gray(x).expand_as(x), x)
    x = torch.where(params.apply_blur.reshape(-1, 1, 1, 1), _gaussian_blur(x, params.sigma), x)
    h, w = x.shape[1:3]
    rows = torch.arange(h, device=x.device).reshape(1, h, 1)
    cols = torch.arange(w, device=x.device).reshape(1, 1, w)
    for e in range(params.erase_box.shape[1]):
        y0, x0, eh, ew = (params.erase_box[:, e, k].reshape(-1, 1, 1) for k in range(4))
        inside = (rows >= y0) & (rows < y0 + eh) & (cols >= x0) & (cols < x0 + ew)
        erase = params.apply_erase[:, e].reshape(-1, 1, 1) & inside
        x = torch.where(erase[..., None], params.erase_noise[:, e].to(x.dtype), x)
    return x * 255.0

