"""The port's strong augmentation against ubteacher_tpu.data.augment.

Both sides get the same draws: the test replays the JAX key splits
(torch_parity.jax_strong_draws) and hands them to the port's apply step.
Tolerance: the JAX pipeline computes color jitter in bfloat16 (augment.py:379)
and the blur's band matmuls with bf16 operands (:335-340); the port applies
the draws in float32. A bf16 ulp of a [0, 1] pixel is 2^-8, about one unit
of 255; the HSV round trip of the hue jitter multiplies the bf16 error of the
hue by 6 (h6 = 6 * hue, then its fractional part scales the value), so
pixels agree to 10 units of 255 at most and 0.6 on average (measured over
these keys: 7.8 and 0.45 with jitter applied, 1.6 and 0.17 without).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    CANVAS,
    jax_strong_draws,
    synthetic_batch,
    tmp_budget,
)
from ubteacher_tpu.data.augment import strong_augment as j_strong_augment
from ubteacher_tpu_torch.data.augment import apply_strong, draw_strong_params


@pytest.mark.parametrize("key", [7, 11, 3])
def test_apply_strong_matches_jax(key):
    h, w = CANVAS
    images, *_ = synthetic_batch(100, 4, 4, 4)
    draws = jax_strong_draws(jax.random.PRNGKey(key), 4, h, w)
    ref = np.asarray(j_strong_augment(jnp.asarray(images), jax.random.PRNGKey(key)))
    got = apply_strong(torch.from_numpy(images), draws).numpy()
    err = np.abs(got - ref)
    assert err.max() <= 10.0 and err.mean() <= 0.6, (err.max(), err.mean())


def test_draws_cover_the_pipeline():
    """Across these keys every branch (jitter, grayscale, blur, each erasing
    pass) is taken at least once and skipped at least once."""
    h, w = CANVAS
    draws = [jax_strong_draws(jax.random.PRNGKey(k), 4, h, w) for k in (7, 11, 3)]
    for field in ("apply_jitter", "apply_gray", "apply_blur"):
        flags = torch.cat([getattr(d, field) for d in draws])
        assert flags.any() and not flags.all(), field
    erase = torch.cat([d.apply_erase for d in draws])
    assert erase.any(0).all() and not erase.all(0).any()


def test_draw_strong_params_ranges_and_seed():
    h, w = CANVAS
    a = draw_strong_params(16, h, w, torch.Generator().manual_seed(3))
    b = draw_strong_params(16, h, w, torch.Generator().manual_seed(3))
    for f in a.__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert ((a.jitter[:, :3] >= 0.6) & (a.jitter[:, :3] <= 1.4)).all()
    assert (a.jitter[:, 3].abs() <= 0.1).all()
    assert ((a.sigma >= 0.1) & (a.sigma <= 2.0)).all()
    y0, x0, eh, ew = a.erase_box.unbind(-1)
    assert (eh >= 1).all() and (ew >= 1).all()
    assert (y0 >= 0).all() and (y0 + eh <= h).all() and (x0 >= 0).all() and (x0 + ew <= w).all()
    assert a.erase_noise.shape == (16, 3, h, w, 3)
    assert a.erase_noise.min() >= 0 and a.erase_noise.max() <= 1
    out = apply_strong(torch.full((16, h, w, 3), 128.0), a)
    assert out.shape == (16, h, w, 3) and out.min() >= 0 and out.max() <= 255
