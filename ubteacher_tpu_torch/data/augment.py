"""Augmentations (PyTorch port of ubteacher_tpu.data.augment).

Weak geometric augmentation (resize-shortest-edge jitter, horizontal flip,
optional INPUT.CROP, pad to a fixed canvas) runs on the host in numpy, with
the random draws of the JAX package in the same order; it changes geometry,
so it transforms the boxes too (reference DatasetMapperTwoCropSeparate,
data/dataset_mapper.py:92-139). The pixels are resized with the test
loader's `resize_bilinear`, bitwise equal to cv2's INTER_LINEAR on uint8.

Strong photometric augmentation runs on the device inside the train step
(the strong part of ubteacher_tpu.data.augment, :223-410).

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
from typing import Dict, Sequence, Tuple

import numpy as np
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
    # filled on the device: a copy from pageable host memory waits for it
    luma = torch.stack([torch.full((), w, dtype=x.dtype, device=x.device) for w in _LUMA_BGR])
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



# --------------------------------------------------------------------------
# host-side weak augmentation (ubteacher_tpu.data.augment, :32-215)
# --------------------------------------------------------------------------


def resize_shortest_edge_params(
    h: int, w: int, min_size, max_size: int, sampling: str, rng: np.random.Generator,
) -> Tuple[int, int]:
    """Target (new_h, new_w) per D2 ResizeShortestEdge semantics."""
    if sampling == "range":
        size = int(rng.integers(min_size[0], min_size[1] + 1))
    else:  # choice
        size = int(min_size[int(rng.integers(len(min_size)))])
    scale = size / min(h, w)
    if h < w:
        new_h, new_w = size, int(round(scale * w))
    else:
        new_h, new_w = int(round(scale * h)), size
    if max(new_h, new_w) > max_size:
        scale2 = max_size / max(new_h, new_w)
        new_h = int(round(new_h * scale2))
        new_w = int(round(new_w * scale2))
    return new_h, new_w


def random_crop_params(
    h: int, w: int, crop_type: str, crop_size, rng: np.random.Generator
) -> Tuple[int, int, int, int]:
    """(y0, x0, crop_h, crop_w) per D2 RandomCrop.get_crop_size semantics
    (the reference inserts T.RandomCrop before the resize when
    INPUT.CROP.ENABLED, dataset_mapper.py:38-44)."""
    if crop_type == "relative":
        ch, cw = crop_size
        crop_h, crop_w = int(h * ch + 0.5), int(w * cw + 0.5)
    elif crop_type == "relative_range":
        sz = np.asarray(crop_size, np.float32)
        ch, cw = sz + rng.random(2).astype(np.float32) * (1.0 - sz)
        crop_h, crop_w = int(h * ch + 0.5), int(w * cw + 0.5)
    elif crop_type == "absolute":
        crop_h, crop_w = min(int(crop_size[0]), h), min(int(crop_size[1]), w)
    elif crop_type == "absolute_range":
        if crop_size[0] > crop_size[1]:
            raise ValueError(f"absolute_range crop size {crop_size}: min above max")
        crop_h = int(rng.integers(min(h, int(crop_size[0])), min(h, int(crop_size[1])) + 1))
        crop_w = int(rng.integers(min(w, int(crop_size[0])), min(w, int(crop_size[1])) + 1))
    else:
        raise NotImplementedError(f"Unknown crop type {crop_type}")
    y0 = int(rng.integers(h - crop_h + 1))
    x0 = int(rng.integers(w - crop_w + 1))
    return y0, x0, crop_h, crop_w


def weak_augment_geometry(
    h: int,
    w: int,
    boxes: np.ndarray,  # (M, 4) xyxy
    canvas_hw,  # (h, w) or a list of (h, w) candidates (scale buckets)
    min_size,
    max_size: int,
    sampling: str,
    rng: np.random.Generator,
    flip: bool = True,
    crop=None,  # (crop_type, crop_size) to enable INPUT.CROP
) -> Dict:
    """The random draws and box math of `apply_weak_augment`, without pixels.

    Every draw depends only on the image's size (crop window, resize jitter,
    flip coin), never on its pixels, so the loader draws geometry from the
    dataset's metadata in order and materializes the pixels on a pool.
    Returns the record `materialize_weak_augment` consumes: crop window,
    resized (new_h, new_w), chosen canvas, flip flag, transformed boxes,
    keep mask (boxes that survive the crop) and the true hw."""
    keep = np.ones((len(boxes),), bool)
    crop_win = None
    if crop is not None:
        y0, x0, crop_h, crop_w = random_crop_params(h, w, crop[0], crop[1], rng)
        crop_win = (y0, x0, crop_h, crop_w)
        h, w = crop_h, crop_w
        if len(boxes):
            boxes = boxes.astype(np.float32).copy()
            boxes[:, [0, 2]] = (boxes[:, [0, 2]] - x0).clip(0, crop_w)
            boxes[:, [1, 3]] = (boxes[:, [1, 3]] - y0).clip(0, crop_h)
            keep = (boxes[:, 2] - boxes[:, 0] > 1e-5) & (boxes[:, 3] - boxes[:, 1] > 1e-5)
    new_h, new_w = resize_shortest_edge_params(h, w, min_size, max_size, sampling, rng)
    if isinstance(canvas_hw[0], (tuple, list)):
        # the smallest canvas (by area) that holds the jittered size
        candidates = sorted(canvas_hw, key=lambda c: c[0] * c[1])
        canvas_hw = candidates[-1]
        for c in candidates:
            if new_h <= c[0] and new_w <= c[1]:
                canvas_hw = tuple(c)
                break
    # an image larger than every canvas is scaled down into the chosen one
    ch, cw = canvas_hw
    if new_h > ch or new_w > cw:
        s = min(ch / new_h, cw / new_w)
        new_h, new_w = int(new_h * s), int(new_w * s)
    sx, sy = new_w / w, new_h / h
    out_boxes = boxes.astype(np.float32).copy()
    if len(out_boxes):
        out_boxes[:, [0, 2]] *= sx
        out_boxes[:, [1, 3]] *= sy

    do_flip = flip and rng.random() < 0.5
    if do_flip and len(out_boxes):
        x1 = new_w - out_boxes[:, 2]
        x2 = new_w - out_boxes[:, 0]
        out_boxes[:, 0], out_boxes[:, 2] = x1, x2

    return {
        "crop": crop_win,
        "new_hw": (new_h, new_w),
        "boxes": out_boxes,
        "hw": np.asarray([new_h, new_w], np.float32),
        "canvas": (ch, cw),
        "keep": keep,
        "flip": do_flip,
    }


def materialize_weak_augment(image: np.ndarray, geom: Dict) -> np.ndarray:
    """Apply a `weak_augment_geometry` record to a (H, W, 3) uint8 image:
    crop, resize (`resize_bilinear`, cv2's INTER_LINEAR bit for bit), flip,
    zero-pad to the chosen canvas. Returns the (ch, cw, 3) uint8 canvas."""
    from .loader import resize_bilinear  # loader.py imports this module

    if geom["crop"] is not None:
        y0, x0, crop_h, crop_w = geom["crop"]
        image = image[y0 : y0 + crop_h, x0 : x0 + crop_w]
    new_h, new_w = geom["new_hw"]
    resized = resize_bilinear(image, new_h, new_w)
    if geom["flip"]:
        resized = resized[:, ::-1]
    ch, cw = geom["canvas"]
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[:new_h, :new_w] = resized
    return canvas


def apply_weak_augment(
    image: np.ndarray,  # (H, W, 3) uint8, BGR
    boxes: np.ndarray,  # (M, 4) xyxy
    canvas_hw,
    min_size,
    max_size: int,
    sampling: str,
    rng: np.random.Generator,
    flip: bool = True,
    crop=None,
) -> Dict[str, np.ndarray]:
    """Resize jitter + hflip + fit-to-canvas + pad in one call. Returns the
    padded uint8 image, the transformed boxes, the true (h, w) inside the
    canvas, the chosen canvas and the keep mask of the crop.

    `canvas_hw` may be a list of candidate canvases (scale buckets): the
    smallest that holds the jittered size is chosen, so the MIN_SIZE_TRAIN
    range survives on fixed shapes; an image exceeding every bucket is
    downscaled into the largest. `crop=(type, size)` applies D2 RandomCrop
    before the resize; `keep` marks the boxes with positive extent after it
    (D2 filter_empty_instances)."""
    geom = weak_augment_geometry(
        image.shape[0], image.shape[1], boxes, canvas_hw, min_size, max_size,
        sampling, rng, flip=flip, crop=crop,
    )
    return {
        "image": materialize_weak_augment(image, geom),
        "boxes": geom["boxes"],
        "hw": geom["hw"],
        "canvas": geom["canvas"],
        "keep": geom["keep"],
    }
