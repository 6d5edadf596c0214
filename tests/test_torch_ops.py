"""The port's ops (``muggled_dpt_tpu_torch.ops``) against the JAX package's
(``muggled_dpt_tpu.ops``) on the same numpy inputs, in float32 on the CPU.

Layouts differ by design (torch: (out, in) linears, OIHW convs, NCHW maps;
JAX: (in, out), HWIO, NHWC), so each test converts the numpy weights for
the JAX side. Tolerance: 1e-5 absolute and relative unless noted; the two
frameworks sum in different orders in float32."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.ops import nn as jnn
from muggled_dpt_tpu.ops.resize import resize_2d as jax_resize_2d
from muggled_dpt_tpu.ops.resize import resize_output_size as jax_resize_output_size
from muggled_dpt_tpu_torch.ops import nn as tnn
from muggled_dpt_tpu_torch.ops.resize import resize_2d, resize_bicubic_hwc, resize_output_size

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(nhwc):
    return _t(nhwc.transpose(0, 3, 1, 2))


def _nhwc(nchw: torch.Tensor):
    return nchw.numpy().transpose(0, 2, 3, 1)


def test_layer_norm():
    x, w, b = _rand(0, 2, 7, 48, scale=3.0), 1 + _rand(1, 48, scale=0.1), _rand(2, 48)
    got = tnn.layer_norm(_t(x), _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnn.layer_norm(x, w, b)), **TOL)


def test_layer_norm_bf16_has_float32_statistics():
    """bf16 in, bf16 out, statistics in float32: the same as the JAX
    package's bf16 layer_norm to one bf16 rounding (rtol 2**-7)."""
    x, w, b = _rand(3, 2, 5, 256, scale=4.0) + 100.0, 1 + _rand(4, 256, scale=0.1), _rand(5, 256)
    xb, wb, bb = (_t(a).to(torch.bfloat16) for a in (x, w, b))
    got = tnn.layer_norm(xb, wb, bb)
    assert got.dtype == torch.bfloat16
    want = jnn.layer_norm(*(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (xb, wb, bb)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-7)


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(tnn.gelu(_t(x)).numpy(), np.asarray(jnn.gelu(jnp.asarray(x))), **TOL)


def _layer(w, b):
    """A linear layer as the ops take it: ``weight`` (out, in) and ``bias``."""
    return types.SimpleNamespace(weight=_t(w), bias=_t(b))


def test_mlp_gelu():
    x = _rand(4, 2, 9, 32)
    w1, b1, w2, b2 = _rand(5, 128, 32, scale=0.2), _rand(6, 128), _rand(7, 32, 128, scale=0.1), _rand(8, 32)
    got = tnn.mlp_gelu(_t(x), _layer(w1, b1), _layer(w2, b2)).numpy()
    want = jnn.mlp_gelu(x, {"fc1_kernel": w1.T, "fc1_bias": b1, "fc2_kernel": w2.T, "fc2_bias": b2})
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_mlp_swiglu():
    """ViT-Giant's MLP: w12's first half is the gate (silu), its second the value."""
    x = _rand(9, 2, 9, 32)
    w12, b12, w3, b3 = _rand(10, 2 * 24, 32, scale=0.2), _rand(11, 2 * 24), _rand(12, 32, 24, scale=0.2), _rand(13, 32)
    got = tnn.mlp_swiglu(_t(x), _layer(w12, b12), _layer(w3, b3)).numpy()
    want = jnn.mlp_swiglu(x, {"w12_kernel": w12.T, "w12_bias": b12, "w3_kernel": w3.T, "w3_bias": b3})
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_patchify_embed():
    img = _rand(9, 2, 42, 28, 3)  # NHWC, 3 x 2 patches of 14
    w, b = _rand(10, 24, 3, 14, 14, scale=0.05), _rand(11, 24)
    tokens, grid = tnn.patchify_embed(_nchw(img), _t(w), _t(b))
    jtokens, jgrid = jnn.patchify_embed(img, w.transpose(2, 3, 1, 0), b)
    assert grid == tuple(jgrid) == (3, 2)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jtokens), **TOL)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0)])
def test_conv2d(stride, padding):
    x = _rand(12, 2, 11, 9, 8)
    k = 1 if padding == 0 else 3
    w, b = _rand(13, 6, 8, k, k, scale=0.2), _rand(14, 6)
    got = tnn.conv2d(_nchw(x), _t(w), _t(b), stride=stride, padding=padding)
    want = jnn.conv2d(x, w.transpose(2, 3, 1, 0), b, stride=stride, padding=padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_blocky(k):
    x = _rand(15, 2, 5, 6, 8)
    w, b = _rand(16, 8, 6, k, k, scale=0.2), _rand(17, 6)  # torch ConvTranspose2d (in, out, k, k)
    got = tnn.conv_transpose_blocky(_nchw(x), _t(w), _t(b))
    want = jnn.conv_transpose_blocky(x, w.transpose(2, 3, 0, 1), b)
    assert got.shape == (2, 6, 5 * k, 6 * k)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_self_attention_kernel_path_matches_plain_path():
    """On CPU tensors the kernel path runs the kernel's plain version, which
    must agree with the plain (sdpa) path to float32 rounding."""
    x = _t(_rand(18, 2, 50, 128))
    wq, bq, wp, bp = (_rand(19 + i, *s, scale=0.1) for i, s in enumerate([(384, 128), (384,), (128, 128), (128,)]))
    a = tnn.self_attention(x, _layer(wq, bq), _layer(wp, bp), num_heads=2, use_kernel=True)
    b = tnn.self_attention(x, _layer(wq, bq), _layer(wp, bp), num_heads=2, use_kernel=False)
    torch.testing.assert_close(a, b, **TOL)


def test_sdpa_matches_jax_naive():
    q, k, v = (_rand(30 + i, 2, 40, 3, 16) for i in range(3))
    want, _ = jnn.sdpa(q, k, v, impl="naive")
    got = tnn.sdpa(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# bilinear resizes: (align_corners, antialias, in_hw, out_hw)
RESIZES = [
    (False, True, (72, 128), (56, 56)),  # preprocessing, downscale
    (False, True, (30, 40), (56, 84)),  # preprocessing, upscale
    (True, False, (9, 7), (18, 14)),  # fusion x2
    (True, False, (16, 16), (28, 28)),  # head x1.75
    (False, False, (11, 11), (17, 13)),  # BEiT relpos LUT, 6x6 -> 9x7 grid
    (False, False, (63, 63), (127, 127)),  # BEiT-L-512 LUT, 512 -> 1024 px
]


@pytest.mark.parametrize("align,aa,in_hw,out_hw", RESIZES)
def test_resize_matches_jax(align, aa, in_hw, out_hw):
    # preprocessing works on 0..255 floats; tolerance scales with the range
    scale = 255.0 if aa else 1.0
    x = np.abs(_rand(40, 2, *in_hw, 3, scale=scale))
    got = resize_2d(_nchw(x), out_hw, align_corners=align, antialias=aa)
    want = jax_resize_2d(x, out_hw, mode="bilinear", align_corners=align, antialias=aa)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 8), (10, 6)), ((37, 37), (36, 36)), ((5, 7), (12, 3))])
def test_bicubic_hwc_matches_jax_and_2d_interpolate(in_hw, out_hw):
    """The pos-embed resize: two separable passes against the JAX package's
    bicubic matrices and against torch's own 2-D bicubic F.interpolate."""
    grid = _rand(41, *in_hw, 24)
    got = resize_bicubic_hwc(_t(grid), out_hw).numpy()
    want = jax_resize_2d(grid[None], out_hw, mode="bicubic", align_corners=False, antialias=False)[0]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    direct = torch.nn.functional.interpolate(_t(grid).permute(2, 0, 1)[None], size=out_hw, mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got, direct[0].permute(1, 2, 0).numpy(), **TOL)


def test_resize_rejects_other_modes():
    with pytest.raises(ValueError):
        resize_2d(torch.zeros(1, 1, 4, 4), (8, 8), align_corners=True, antialias=True)


def test_plain_bilinear_resize_is_float32():
    """The BEiT LUT mode computes in float32 and returns the input's dtype."""
    x = _t(_rand(42, 1, 2, 11, 11))
    got = resize_2d(x.to(torch.bfloat16), (17, 13))
    assert got.dtype == torch.bfloat16
    want = torch.nn.functional.interpolate(x.to(torch.bfloat16).float(), size=(17, 13), mode="bilinear", align_corners=False)
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("hw,s", [((36, 36), 2.0), ((72, 40), 1.75), ((7, 9), 1.75), ((5, 5), 0.5)])
def test_resize_output_size(hw, s):
    assert resize_output_size(hw, s) == jax_resize_output_size(hw, s)
