"""The test loader's resize (ubteacher_tpu_torch/data/loader.py:resize_bilinear)
against cv2.resize(..., interpolation=cv2.INTER_LINEAR), which the JAX
loader calls: bitwise, on uint8 images, over down- and up-scales, exact 2x
downscales (cv2's area path), sides of 1-3 pixels and the test canvases."""

import numpy as np
import pytest

from ubteacher_tpu_torch.data.loader import resize_bilinear

cv2 = pytest.importorskip("cv2")

# (source H, W) -> (target H, W)
SIZES = [
    ((30, 50), (24, 40)),       # downscale, both axes
    ((33, 47), (70, 99)),       # upscale, both axes
    ((37, 40), (53, 40)),       # one axis only (rows)
    ((37, 40), (37, 71)),       # one axis only (columns)
    ((61, 99), (45, 140)),      # down one axis, up the other
    ((64, 128), (32, 64)),      # exact 2x down (cv2's area path)
    ((100, 150), (50, 75)),
    ((2, 2), (1, 1)),
    ((64, 128), (32, 128)),     # 2x on one axis only: the linear path
    ((1, 1), (3, 5)),           # sides of 1-3 pixels
    ((1, 7), (2, 3)),
    ((3, 2), (1, 1)),
    ((2, 3), (9, 1)),
    ((5, 3), (3, 2)),
    ((480, 640), (800, 1067)),  # the test canvases: 800 short edge, 1344 cap
    ((640, 427), (1199, 800)),
    ((427, 640), (800, 1199)),
    ((1000, 500), (1344, 672)),
    ((20, 90), (16, 70)),       # tests/test_torch_eval.py's loader sizes
    ((41, 80), (36, 70)),
]


@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d in SIZES])
def test_resize_bitwise_equal_to_cv2(src, dst):
    rng = np.random.default_rng(src[0] * 1000 + src[1])
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    got = resize_bilinear(img, *dst)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_resize_bitwise_on_random_sizes():
    """300 random source and target sizes up to 160 a side, one channel
    count of 3 and one of 1."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w, nh, nw = (int(v) for v in rng.integers(1, 161, 4))
        cn = int(rng.choice([1, 3]))
        img = rng.integers(0, 256, (h, w, cn), dtype=np.uint8)
        ref = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR).reshape(nh, nw, cn)
        np.testing.assert_array_equal(resize_bilinear(img, nh, nw), ref, err_msg=f"{(h, w, cn)} -> {(nh, nw)}")


def test_resize_extremes_and_refusals():
    # saturated pixels stay in range; a float or 2-D image is refused
    img = np.full((7, 9, 3), 255, np.uint8)
    img[::2] = 0
    np.testing.assert_array_equal(resize_bilinear(img, 11, 4),
                                  cv2.resize(img, (4, 11), interpolation=cv2.INTER_LINEAR))
    with pytest.raises(ValueError):
        resize_bilinear(img.astype(np.float32), 4, 4)
    with pytest.raises(ValueError):
        resize_bilinear(img[..., 0], 4, 4)
