"""The port's GIoU loss and its hand-written gradient against the JAX package,
on the CPU.

`ops.losses.giou_loss_grad` (the plain version of the CUDA backward kernel,
csrc/giou.cu, which does the same arithmetic) and `giou_loss`, which goes
through the same autograd Function as on the card with the plain forward and
backward in place of the kernels, are held against jax.grad of
ubteacher_tpu/ops/losses.py:iou_loss and of
giou_loss_pallas(..., interpret=True) on a few hundred seeded rows: random
rows, rows where pred equals target in one, two and all four coordinates
(minimum/maximum split the gradient in half on a tie), rows with ac == 0,
weight-0 rows, and rows with an inf or NaN pred at weight 0 and at weight > 0,
where the NaN positions must be equal. Tolerance rtol 1e-5 / atol 1e-7:
float32 sums of the same terms, with JAX's division gradient rounded as
(-g * x) * y**-2 where autograd's is -g * ((x / y) / y).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.ops import losses as JL
from ubteacher_tpu.ops.pallas import giou_loss_pallas
from ubteacher_tpu_torch.ops import losses as TL
from ubteacher_tpu_torch.ops.kernels import giou_cuda

N = 300
ROW_SETS = ("random", "tie1", "tie2", "tie4", "ac0", "ac0_width", "weight0", "nonfinite_w0", "nonfinite_w")


def _ltrb(rng, n):
    return (rng.random((n, 4)) * 10 + 0.5).astype(np.float32)


def _rows(name):
    """(pred, target, weight) float32 rows of one set, seeded by its name."""
    rng = np.random.default_rng(ROW_SETS.index(name))
    p, t, w = _ltrb(rng, N), _ltrb(rng, N), rng.random(N).astype(np.float32)
    if name.startswith("tie"):
        k = int(name[3:])
        for i in range(N):
            cols = rng.choice(4, k, replace=False)
            t[i, cols] = p[i, cols]
    elif name == "ac0":  # every coordinate 0: ac == 0, every min/max a tie
        p[:] = 0.0
        t[:] = 0.0
    elif name == "ac0_width":  # zero width on both sides: ac == 0, heights not
        p[:, [0, 2]] = 0.0
        t[:, [0, 2]] = 0.0
    elif name == "weight0":
        w[::2] = 0.0
    elif name.startswith("nonfinite"):
        bad = (np.inf, -np.inf, np.nan)
        for i in range(N):
            p[i, i % 4] = bad[(i // 4) % 3]
        w[::2] = 0.0
        if name == "nonfinite_w0":
            w[:] = 0.0
    return p, t, w


def _assert_close_nan_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def _jax_grads(p, t, w, g):
    """jax.grad of the per-row weighted losses against the upstream g, via
    the jnp loss and the interpreted Pallas kernel (their weight w * g)."""
    wg = jnp.asarray(w * g)
    ref = jax.grad(lambda pp: JL.iou_loss(pp, jnp.asarray(t), wg, "giou"))(jnp.asarray(p))
    pal = jax.grad(lambda pp: giou_loss_pallas(pp, jnp.asarray(t), wg, True))(jnp.asarray(p))
    return ref, pal


@pytest.mark.parametrize("name", ROW_SETS)
def test_giou_grad_plain_matches_jax(name):
    p, t, w = _rows(name)
    g = np.random.default_rng(100 + ROW_SETS.index(name)).random(N).astype(np.float32)
    got = giou_cuda.giou_rows_grad_plain(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w),
                                         torch.from_numpy(g))
    for want in _jax_grads(p, t, w, g):
        _assert_close_nan_equal(got.numpy(), want)
    if name.startswith("nonfinite"):
        assert np.isnan(got.numpy()).any()


@pytest.mark.parametrize("name,rows_apart", [("nonfinite_w0", 49), ("nonfinite_w", 56)])
def test_giou_grad_nan_rule_is_jax_not_autograd(name, rows_apart):
    """The kept deviation, pinned: autograd's minimum/maximum backward writes
    0 to the losing side (masked_fill) where jax.grad multiplies a NaN or inf
    upstream gradient by 0 and gets NaN. The plain gradient follows JAX, so
    it is NaN wherever autograd is, agrees with autograd where both are
    finite, and puts NaN elsewhere than autograd on `rows_apart` rows."""
    p, t, w = _rows(name)
    g = np.random.default_rng(100 + ROW_SETS.index(name)).random(N).astype(np.float32)
    leaf = torch.from_numpy(p).requires_grad_(True)
    (auto,) = torch.autograd.grad(giou_cuda.giou_rows_plain(leaf, torch.from_numpy(t), torch.from_numpy(w)),
                                  leaf, torch.from_numpy(g))
    got = giou_cuda.giou_rows_grad_plain(*(torch.from_numpy(a) for a in (p, t, w, g))).numpy()
    auto = auto.numpy()
    assert not (np.isnan(auto) & ~np.isnan(got)).any()
    both = ~np.isnan(auto) & ~np.isnan(got)
    np.testing.assert_allclose(got[both], auto[both], rtol=1e-5, atol=1e-7)
    assert int((np.isnan(auto) != np.isnan(got)).any(1).sum()) == rows_apart


def test_giou_grad_tie_splits_in_half():
    """One row whose pred equals its target in every coordinate: each
    coordinate's min and max share go half to pred (JAX's and torch's rule)."""
    p = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
    w = np.ones(1, np.float32)
    got = TL.giou_loss_grad(torch.from_numpy(p), torch.from_numpy(p), torch.from_numpy(w), torch.ones(1))
    pt = torch.from_numpy(p).requires_grad_(True)
    (TL.iou_loss_rows(pt, torch.from_numpy(p), "giou") * torch.from_numpy(w)).sum().backward()
    for want in _jax_grads(p, p, w, np.ones(1, np.float32)) + (pt.grad,):
        _assert_close_nan_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ROW_SETS)
def test_giou_loss_autograd_function_matches_jax(name):
    """giou_loss on CPU tensors: _GIoUFn with the plain forward and the
    analytic backward, the upstream gradient the stride-0 expand of
    rows.sum()'s scalar, forward and gradient against JAX."""
    p, t, w = _rows(name)
    pt = torch.from_numpy(p).requires_grad_(True)
    loss = giou_cuda.giou_loss(pt, torch.from_numpy(t), torch.from_numpy(w))
    assert type(loss.grad_fn.next_functions[0][0]).__name__ == "_GIoUFnBackward"
    ref = JL.iou_loss(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w), "giou")
    pal = giou_loss_pallas(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w), True)
    for want in (ref, pal):
        _assert_close_nan_equal(np.float32(loss.detach()), np.float32(want))
    loss.backward()
    for want in _jax_grads(p, t, w, np.ones(N, np.float32)):
        _assert_close_nan_equal(pt.grad.numpy(), want)


def test_giou_loss_backward_takes_stride0_gradient(monkeypatch):
    """The backward receives rows.sum()'s gradient as a stride-0 expand and
    hands it on as it is, without a contiguous copy; a scaled loss scales it."""
    seen = []
    plain = giou_cuda.giou_rows_grad_plain

    def record(pred, target, weight, grad_rows):
        seen.append((grad_rows.stride(), float(grad_rows[0])))
        return plain(pred, target, weight, grad_rows)

    monkeypatch.setattr(giou_cuda, "giou_rows_grad_plain", record)
    p, t, w = _rows("random")
    pt = torch.from_numpy(p).requires_grad_(True)
    (3.0 * giou_cuda.giou_loss(pt, torch.from_numpy(t), torch.from_numpy(w))).backward()
    assert seen == [((0,), 3.0)]
    want = plain(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w), torch.full((N,), 3.0))
    assert torch.equal(pt.grad, want)


def test_giou_loss_flattens_leading_dims():
    """(B, L, 4) rows, as fcos_supervised_losses passes them: the same sum and
    gradient as the (B * L, 4) rows."""
    p, t, w = _rows("weight0")
    p3 = torch.from_numpy(p).reshape(3, N // 3, 4).requires_grad_(True)
    giou_cuda.giou_loss(p3, torch.from_numpy(t).reshape(3, N // 3, 4), torch.from_numpy(w).reshape(3, N // 3)).backward()
    p2 = torch.from_numpy(p).requires_grad_(True)
    giou_cuda.giou_loss(p2, torch.from_numpy(t), torch.from_numpy(w)).backward()
    assert torch.equal(p3.grad.reshape(N, 4), p2.grad)


def test_giou_kernels_refuse_cpu_tensors():
    """On CPU tensors both launchers raise and count no launch."""
    before = dict(giou_cuda.LAUNCHES)
    rows, w = torch.ones((4, 4)), torch.ones(4)
    with pytest.raises(ValueError):
        giou_cuda.giou_rows_kernel(rows, rows, w)
    with pytest.raises(ValueError):
        giou_cuda.giou_rows_grad_kernel(rows, rows, w, torch.ones(()).expand(4))
    with pytest.raises(ValueError):  # shapes are checked first
        giou_cuda.giou_rows_grad_kernel(rows, rows[:3], w, w)
    assert giou_cuda.LAUNCHES == before
