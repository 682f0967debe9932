"""The port's fused stem (ops/stem.py) against the JAX package's
(ubteacher_tpu/ops/pallas/stem_pallas.py), on the CPU: the port's plain
version against the Pallas kernel in interpret mode, at the shapes and with
the tolerances of tests/test_stem_pallas.py (float32 rtol 1e-5 / atol 1e-4:
the two sum the 147 products in other orders), and the port's ResNet in
"pallas" mode against the JAX ResNet in "pallas_interpret" mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubteacher_tpu.modeling.resnet import ResNet as JResNet
from ubteacher_tpu.ops.pallas.stem_pallas import _reference, stem_conv_pool as j_stem
from ubteacher_tpu_torch.checkpoint import params_from_jax
from ubteacher_tpu_torch.modeling.resnet import ResNet
from ubteacher_tpu_torch.ops.kernels import stem_cuda
from ubteacher_tpu_torch.ops.stem import stem_conv_pool, stem_conv_pool_plain


def _inputs(b, h, w, feat=64, seed=0):
    """numpy inputs of test_stem_pallas.py: image x 50, kernel x 0.1."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, 3).astype(np.float32) * 50
    k = rng.randn(7, 7, 3, feat).astype(np.float32) * 0.1
    scale = rng.uniform(0.5, 2.0, feat).astype(np.float32)
    bias = rng.randn(feat).astype(np.float32)
    return x, k, scale, bias


def _port(x, k, s, b, dtype):
    out = stem_conv_pool(*(torch.from_numpy(a) for a in (x, k, s, b)), dtype)
    return out.float().numpy()


@pytest.mark.parametrize("hw", [(64, 128), (96, 160), (128, 224)])
def test_plain_matches_jax_kernel_f32(hw):
    h, w = hw
    args = _inputs(2, h, w)
    ref = np.asarray(j_stem(*map(jnp.asarray, args), jnp.float32, True))
    got = _port(*args, torch.float32)
    assert got.shape == ref.shape == (2, h // 4, w // 4, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_bf16_error_no_worse_than_jax_bf16():
    # the criterion of test_stem_pallas.py: against the float32 truth, the
    # port's bf16 result is as accurate as the JAX kernel's bf16 result
    args = _inputs(1, 64, 128, seed=3)
    jargs = tuple(map(jnp.asarray, args))
    truth = np.asarray(_reference(*jargs, jnp.float32))
    ref16 = np.asarray(j_stem(*jargs, jnp.bfloat16, True), dtype=np.float32)
    got16 = _port(*args, torch.bfloat16)
    denom = np.maximum(np.abs(truth), 1.0)
    err_ref = np.abs(ref16 - truth) / denom
    err_got = np.abs(got16 - truth) / denom
    assert np.max(err_got) < max(2.0 * np.max(err_ref), 0.02)
    assert np.mean(err_got) < 2.0 * np.mean(err_ref) + 1e-4


def test_edge_rows_and_cols_exact():
    # pooled row/col 0 exclude the pad line; a wrong pad inclusion would
    # inject relu(bias) = 7 on the even channels
    x, k, s, b = _inputs(1, 64, 128, seed=7)
    b = b - 5.0
    b[::2] = 7.0
    ref = np.asarray(j_stem(*map(jnp.asarray, (x, k, s, b)), jnp.float32, True))
    got = _port(x, k, s, b, torch.float32)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[:, :, 0], ref[:, :, 0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[:, -1], ref[:, -1], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[:, :, -1], ref[:, :, -1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hw", [(60, 100), (61, 99), (5, 3)])
def test_shapes_the_jax_kernel_refuses(hw):
    # JAX falls back to its XLA composition here (H % 4 != 0); the port
    # takes every shape, with output ceil(H/4) x ceil(W/4)
    args = _inputs(1, *hw, seed=1)
    ref = np.asarray(_reference(*map(jnp.asarray, args), jnp.float32))
    got = _port(*args, torch.float32)
    assert got.shape == ref.shape == (1, -(-hw[0] // 4), -(-hw[1] // 4), 64)
    assert stem_cuda.pooled_size(hw[0]) == got.shape[1]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_grad_matches_jax():
    """The autograd.Function's backward (the plain version differentiated)
    against jax.grad of the JAX stem_conv_pool (its custom_vjp), for every
    input, under a random output cotangent."""
    x, k, s, b = _inputs(1, 64, 128, seed=2)
    cot = np.random.RandomState(5).randn(1, 16, 32, 64).astype(np.float32)

    def f(*a):
        return jnp.sum(j_stem(*a, jnp.float32, True) * cot)

    ref = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, k, s, b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, k, s, b)]
    (stem_conv_pool(*leaves, torch.float32) * torch.from_numpy(cot)).sum().backward()
    for name, t, r in zip(("x", "kernel", "scale", "bias"), leaves, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_plain_is_dtype_stable_under_autocast():
    # the plain version sets its own dtypes: autocast around it changes nothing
    args = [torch.from_numpy(a) for a in _inputs(1, 32, 48, seed=4)]
    ref = stem_conv_pool_plain(*args, torch.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = stem_conv_pool_plain(*args, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _resnets(seed):
    """JAX ResNet-18 (float32) in "pallas_interpret" mode with its params,
    and the port's ResNet-18 in "pallas" mode with them loaded."""
    # unit-scale input, as test_stem_pallas.py's ResNet tests use
    x = np.random.RandomState(seed).randn(1, 64, 128, 3).astype(np.float32)
    jnet = JResNet(depth=18, stem_mode="pallas_interpret", dtype=jnp.float32,
                   out_features=("res2", "res3", "res4", "res5"))
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    # a nontrivial stem affine
    rng = np.random.RandomState(seed + 1)
    params["stem_conv1_norm"]["scale"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    params["stem_conv1_norm"]["bias"] = rng.randn(64).astype(np.float32)
    net = ResNet(depth=18, stem_mode="pallas", out_features=("res2", "res3", "res4", "res5"))
    missing, unexpected = net.load_state_dict(params_from_jax(params), strict=True)
    assert not missing and not unexpected
    return jnet, params, net, x


def test_resnet_pallas_mode_matches_jax():
    jnet, params, net, x = _resnets(0)
    ref = jnet.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_resnet_stem_modes_agree_and_refuse():
    _, params, net, x = _resnets(1)
    conv = ResNet(depth=18, stem_mode="conv", out_features=("res2", "res3", "res4", "res5"))
    conv.load_state_dict(params_from_jax(params), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        a, c = conv(xt), net(xt)
        # under autocast both modes hand the stages bf16
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert net.stem(xt).dtype == conv.stem(xt).dtype == torch.bfloat16
    for key in a:
        np.testing.assert_allclose(c[key].numpy(), a[key].numpy(), rtol=1e-4, atol=1e-4, err_msg=key)
    for mode in ResNet.UNPORTED_STEM_MODES:
        with pytest.raises(ValueError, match="Do not port"):
            ResNet(depth=18, stem_mode=mode)
    with pytest.raises(ValueError, match="unknown stem_mode"):
        ResNet(depth=18, stem_mode="palas")


def test_stem_launcher_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(1, 16, 16)]
    before = dict(stem_cuda.LAUNCHES)
    with pytest.raises(ValueError):
        stem_cuda.stem_conv_pool_kernel(*args, torch.float32)
    assert stem_cuda.LAUNCHES == before


def _staged(x, hp, wp):
    """The bf16 kernel's staging in float32: pixel (r, u) of the image,
    zero padded by 3 on the top and left and out to hp x wp, laid out row by
    row with the 3 channels interleaved, (B, hp, 3 wp). Each value is read
    from x's storage at b sb + r sh + u sw + ci sc, x's own strides, as the
    kernel reads it."""
    b, h, w, _ = x.shape
    flat = torch.as_strided(x, (x.untyped_storage().nbytes() // x.element_size(),), (1,), 0)
    sb, sh, sw, sc = x.stride()
    r = torch.arange(hp)[:, None, None] - 3
    u = torch.arange(wp)[None, :, None] - 3
    ci = torch.arange(3)[None, None, :]
    inside = (r >= 0) & (r < h) & (u >= 0) & (u < w)
    idx = x.storage_offset() + r.clamp(0, h - 1) * sh + u.clamp(0, w - 1) * sw + ci * sc
    out = torch.stack([torch.where(inside, flat[bi * sb + idx], 0.0) for bi in range(b)])
    return out.reshape(b, hp, wp * 3).contiguous()


def _kdecomp_stem(x, kernel, scale, bias, mask_pad=True):
    """The tensor-core kernel's K decomposition in float32: for each of the 7
    ky slices, A is a strided view of the staged rows (conv pixel (r, c),
    tap t at element 6 c + t of staged row 2 r + ky) over 24 taps, the last
    3 zeroed (or, with mask_pad=False, left reading the next pixel), and B
    holds the 21 folded weights of the slice and 3 zero rows; the sum over
    the slices, the bias, ReLU, 0 outside the conv output, then the 3-row and
    3-column maxima."""
    b, h, w, _ = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    hp, wp = 2 * ho + 7, 2 * wo + 7  # the last conv column's pad taps stay inside
    st = _staged(x, hp, wp)
    kf = kernel.float() * scale.float()
    acc = torch.zeros((b, ho, wo, 64))
    sb, sr, _ = st.stride()
    for ky in range(7):
        a = torch.as_strided(st, (b, ho, wo, 24), (sb, 2 * sr, 6, 1), ky * sr)
        if mask_pad:
            a = torch.where(torch.arange(24) < 21, a, 0.0)
        bm = torch.cat([kf[ky].reshape(21, 64), torch.zeros((3, 64))])
        acc = acc + a @ bm
    y = torch.relu(acc + bias.float())
    y = torch.nn.functional.pad(y, (0, 0, 1, 1, 1, 1))  # 0 outside: every window holds a real tap >= 0
    y = torch.maximum(torch.maximum(y[:, :, :-2], y[:, :, 1:-1]), y[:, :, 2:])[:, :, ::2]
    return torch.maximum(torch.maximum(y[:, :-2], y[:, 1:-1]), y[:, 2:])[:, ::2]


@pytest.mark.parametrize("hw", [(61, 99), (5, 3), (128, 224)])
def test_kernel_k_decomposition_matches_plain(hw):
    """The bf16 kernel's K layout (7 ky slices of 24 taps, zero pad) over
    strided views, from the NHWC tensor and from the permuted view of an
    NCHW tensor (bitwise the same), equals the plain version in float32,
    and the Pallas kernel interpreted where the JAX tests run it (H % 4 ==
    0)."""
    x, k, s, b = _inputs(2, *hw, seed=11)
    xt = torch.from_numpy(x)
    nchw_view = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not nchw_view.is_contiguous()
    args = [torch.from_numpy(a) for a in (k, s, b)]
    got = _kdecomp_stem(xt, *args)
    assert torch.equal(_kdecomp_stem(nchw_view, *args), got)
    ref = stem_conv_pool_plain(xt, *args, torch.float32)
    assert got.shape == ref.shape == (2, stem_cuda.pooled_size(hw[0]), stem_cuda.pooled_size(hw[1]), 64)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)
    if hw[0] % 4 == 0 and hw[1] % 4 == 0:
        jref = np.asarray(j_stem(*map(jnp.asarray, (x, k, s, b)), jnp.float32, True))
        np.testing.assert_allclose(got.numpy(), jref, rtol=1e-5, atol=1e-4)


def test_kernel_pad_taps_must_read_zero():
    """A NaN pixel just right of a conv window (column 4 q + 6, read by the
    pad taps of conv column 2 q + 1) leaves the plain version's pooled
    column q finite: the decomposition with the pad taps masked keeps it so,
    and reading the next pixel there instead (0 weight, but NaN x 0) would
    not."""
    x, k, s, b = _inputs(1, 32, 48, seed=12)
    x[0, 10, 4 * 3 + 6, 1] = np.nan
    xt = torch.from_numpy(x)
    args = [torch.from_numpy(a) for a in (k, s, b)]
    ref = stem_conv_pool_plain(xt, *args, torch.float32)
    fin = torch.isfinite(ref)
    assert bool(fin[0, :, 3].all()) and not bool(fin.all())
    got = _kdecomp_stem(xt, *args)
    np.testing.assert_allclose(got[fin].numpy(), ref[fin].numpy(), rtol=1e-5, atol=1e-4)
    leaky = _kdecomp_stem(xt, *args, mask_pad=False)
    assert not bool(torch.isfinite(leaky[0, :, 3]).all())
