"""The port's biased attention and its (B, N, H, D) entry (the plain
versions, which the wrappers run for CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs. The cases mirror
tests/test_flash_attention.py.

Tolerance: atol = rtol = 2e-5 in float32, as the JAX package holds its own
kernels to its naive reference: the two differ only in float32 summation
order and exp vs exp2."""

import types

import numpy as np
import pytest
import torch

from muggled_dpt_tpu.ops.pallas.flash_attention import _flash_bhnd_prescaled
from muggled_dpt_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from muggled_dpt_tpu.ops.pallas.flash_attention import flash_attention_fused_qkv as jax_fused_qkv
from muggled_dpt_tpu_torch.ops import nn as tnn
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)
D = 64  # the kernel's head width


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(seed, b, n, h, all_negative=False):
    """Head-major (B, N, 3C) qkv and its (B, N, H, D) q, k, v."""
    x = _rand(seed, b, n, h, 3, D)
    if all_negative:  # every logit strongly negative: q = -8|x|, k = |y|
        x[..., 0, :] = -8.0 * np.abs(x[..., 0, :])
        x[..., 1, :] = np.abs(x[..., 1, :])
    return x.reshape(b, n, 3 * h * D), x[..., 0, :], x[..., 1, :], x[..., 2, :]


def _fused(qkv, h, **kw):
    return fa.flash_attention_fused_qkv(_t(qkv), h, **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}).numpy()


def _bnhd(q, k, v, bias=None, scale=None):
    return fa.flash_attention(_t(q), _t(k), _t(v), bias=None if bias is None else _t(bias), scale=scale).numpy()


def test_biased_fused_qkv_matches_jax_kernel():
    b, n, h = 2, 200, 2
    qkv, *_ = _qkv(7, b, n, h)
    bias = _rand(8, b, h, n, n)
    want = np.asarray(jax_fused_qkv(qkv, h, bias=bias, interpret=True))
    np.testing.assert_allclose(_fused(qkv, h, bias=bias), want, **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_prepadded_bias_with_huge_pads_matches_jax_kernel(fused):
    """BEiT's cached stack arrives padded past N; the pads (1e6 here) must
    never reach the softmax."""
    b, n, h, n_pad = 1, 200, 2, 256
    qkv, q, k, v = _qkv(9, b, n, h)
    bias = np.pad(_rand(10, b, h, n, n), ((0, 0), (0, 0), (0, n_pad - n), (0, n_pad - n)), constant_values=1e6)
    if fused:
        got, want = _fused(qkv, h, bias=bias), np.asarray(jax_fused_qkv(qkv, h, bias=bias, interpret=True))
    else:
        got, want = _bnhd(q, k, v, bias), np.asarray(jax_flash(q, k, v, bias=bias, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_indexed_bias_stack_matches_jax_kernel():
    b, n, h, layers, n_pad = 1, 200, 2, 3, 256
    qkv, *_ = _qkv(12, b, n, h)
    stack = _rand(13, layers, h, n_pad, n_pad)
    for layer in range(layers):
        want = np.asarray(jax_fused_qkv(qkv, h, bias_stack=stack, layer=np.int32(layer), interpret=True))
        np.testing.assert_allclose(_fused(qkv, h, bias_stack=stack, layer=layer), want, **TOL, err_msg=f"layer {layer}")


@pytest.mark.parametrize("bias_shape", [(1, 1, 1, None), ("b", "h", 1, None), (1, 1, None, 1)])
def test_broadcast_sized_bias_matches_jax_kernels(bias_shape):
    """Size-1 trailing dims broadcast over the sequence, in both entries."""
    b, n, h = 1, 200, 2
    qkv, q, k, v = _qkv(3, b, n, h)
    shape = tuple(n if s is None else (b if s == "b" else (h if s == "h" else s)) for s in bias_shape)
    bias = _rand(4, *shape, scale=4.0)
    np.testing.assert_allclose(_bnhd(q, k, v, bias), np.asarray(jax_flash(q, k, v, bias=bias, interpret=True)), **TOL)
    np.testing.assert_allclose(_fused(qkv, h, bias=bias), np.asarray(jax_fused_qkv(qkv, h, bias=bias, interpret=True)), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_all_logits_negative_with_bias_matches_jax_kernel(fused):
    """n=130 leaves a ragged tail, and every real logit is far below zero
    (a -40 bias on negative q.k): the case a pad-count correction gets wrong."""
    b, n, h = 1, 130, 2
    qkv, q, k, v = _qkv(5, b, n, h, all_negative=True)
    bias = np.full((1, 1, n, n), -40.0, np.float32)
    if fused:
        got, want = _fused(qkv, h, bias=bias), np.asarray(jax_fused_qkv(qkv, h, bias=bias, interpret=True))
    else:
        got, want = _bnhd(q, k, v, bias), np.asarray(jax_flash(q, k, v, bias=bias, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_online_path_matches_jax_online_kernel(with_bias):
    """The JAX package's streamed-key kernel (#5), forced with one_pass=False,
    against the port's (B, N, H, D) entry: the port streams keys at every N."""
    n = 2148
    q, k, v = (_rand(20 + i, 1, n, 1, D) for i in range(3))
    bias = _rand(23, 1, n, n) if with_bias else None
    scale = D**-0.5
    want = np.asarray(_flash_bhnd_prescaled(q[:, :, 0] * scale, k[:, :, 0], v[:, :, 0], bias, interpret=True, one_pass=False))
    got = _bnhd(q, k, v, None if bias is None else bias[:, None])[:, :, 0]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_custom_scale_with_bias_matches_jax_kernel(fused):
    b, n, h = 1, 100, 2
    qkv, q, k, v = _qkv(1, b, n, h)
    bias = _rand(2, 1, h, n, n)
    if fused:
        got, want = _fused(qkv, h, bias=bias, scale=0.3), np.asarray(jax_fused_qkv(qkv, h, bias=bias, scale=0.3, interpret=True))
    else:
        got, want = _bnhd(q, k, v, bias, scale=0.3), np.asarray(jax_flash(q, k, v, bias=bias, scale=0.3, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_bnhd_entry_on_strided_views_equals_fused_entry():
    """q, k and v as strided views of one qkv give what the fused entry gives."""
    b, n, h = 2, 70, 2
    qkv, *_ = _qkv(6, b, n, h)
    x = _t(qkv).unflatten(2, (h, 3, D))
    bias = _t(_rand(7, 1, h, n, n))
    got = fa.flash_attention(x[..., 0, :], x[..., 1, :], x[..., 2, :], bias=bias)
    want = fa.flash_attention_fused_qkv(_t(qkv), h, bias=bias).reshape(b, n, h, D)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_self_attention_stack_tuple_equals_dense_layer_bias():
    """self_attention's (stack, layer) bias is the layer's slice, in the
    kernel entry and in the plain path."""
    x = _t(_rand(30, 2, 40, 128))
    wq, bq, wp, bp = (_t(_rand(31 + i, *s, scale=0.1)) for i, s in enumerate([(384, 128), (384,), (128, 128), (128,)]))
    qkv, proj = types.SimpleNamespace(weight=wq, bias=bq), types.SimpleNamespace(weight=wp, bias=bp)
    stack = _t(np.pad(_rand(40, 3, 2, 40, 40), ((0, 0), (0, 0), (0, 8), (0, 8)), constant_values=1e6))
    dense = stack[1:2, :, :40, :40]
    want = tnn.self_attention(x, qkv, proj, 2, use_kernel=False, bias=dense)
    for use_kernel in (True, False):
        got = tnn.self_attention(x, qkv, proj, 2, use_kernel=use_kernel, bias=(stack, 1))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sdpa_slices_prepadded_bias():
    q, k, v = (_t(_rand(50 + i, 1, 50, 2, 16)) for i in range(3))
    bias = _t(_rand(53, 1, 2, 50, 50))
    padded = torch.nn.functional.pad(bias, (0, 78, 0, 78), value=1e6)
    torch.testing.assert_close(tnn.sdpa(q, k, v, bias=padded), tnn.sdpa(q, k, v, bias=bias), rtol=0, atol=0)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    fa.reset_launch_counts()
    qkv, q, k, v = _qkv(8, 1, 60, 2)
    bias = _rand(9, 1, 2, 60, 60)
    stack = _rand(10, 2, 2, 64, 64)
    _fused(qkv, 2)
    _fused(qkv, 2, bias=bias)
    _fused(qkv, 2, bias_stack=stack, layer=1)
    _bnhd(q, k, v, bias)
    assert fa.launch_counts() == {"fused": 0, "fused_biased": 0, "bnhd": 0, "window": 0, "window_sm90": 0, "fused_f16": 0,
                                  "fused_biased_f16": 0, "bnhd_f16": 0, "window_f16": 0, "window_sm90_f16": 0, "fused_mlp": 0,
                                  "fused_mlp_sm90": 0, "head_tail": 0, "head_tail_sm90": 0, "int8_qk": 0, "int8_qk_sm90": 0,
                                  "int8_qk_fused": 0, "int8_qk_fused_sm90": 0, "xl": 0, "staged": 0, "variant": 0,
                                  "upsample_ac": 0, "upsample_ac_nchw": 0, "cosine_qk": 0,
                                  "postnorm_residual": 0, "swiglu_gate": 0}
    torch.testing.assert_close(
        fa.flash_attention_fused_qkv(_t(qkv), 2, bias=_t(bias)),
        fa.flash_attention_fused_qkv_reference(_t(qkv), 2, bias=_t(bias)),
        rtol=0, atol=0,
    )


def test_bad_bias_shapes_and_arguments_raise():
    b, n, h = 2, 30, 2
    qkv, q, k, v = (_t(a) for a in _qkv(11, b, n, h))
    bad = [(3, h, n, n), (1, 3, n, n), (1, h, n - 1, n), (1, h, n, 7), (n,), (1, 1, 1, 1, n)]
    for shape in bad:
        with pytest.raises(ValueError):
            fa.flash_attention_fused_qkv(qkv, h, bias=torch.zeros(shape))
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, bias=torch.zeros(shape))
    stack = torch.zeros(3, h, 32, 32)
    for kw in ({"bias_stack": stack}, {"bias_stack": stack, "layer": 3}, {"bias_stack": stack[0], "layer": 0},
               {"bias_stack": stack, "layer": 0, "bias": stack[0][None]}):
        with pytest.raises(ValueError):
            fa.flash_attention_fused_qkv(qkv, h, **kw)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :-1], v)
    with pytest.raises(ValueError):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_launcher_refuses_what_it_cannot_take():
    """What the CUDA kernel cannot take raises before any launch: another
    head width or dtype (float64: float16 is taken, and packs dtype code 2),
    a head dim that is not contiguous, rows that are not 16-byte aligned, a
    non-finite scale, a batch past the grid limit."""
    b, n, h = 1, 16, 2

    def bnhd(d=D, dtype=torch.bfloat16):
        return torch.zeros(b, n, h, d, dtype=dtype)

    def refused(q, k=None, v=None, scale=0.125):
        k, v = (q if t is None else t for t in (k, v))
        with pytest.raises(ValueError):
            specs = [fa._operand(name, t, q.device, q.dtype) for name, t in (("q", q), ("k", k), ("v", v))]
            fa._launch(tuple(q.shape), q.dtype, q.device, *specs, specs[0], fa._NO_BIAS, scale)

    refused(bnhd(d=32))
    refused(bnhd(dtype=torch.float64))
    half = bnhd(dtype=torch.float16)
    assert fa._operand("q", half, half.device, torch.float16) == (half.data_ptr(), *half.stride()[:3])
    refused(bnhd(), scale=float("inf"))
    refused(torch.zeros(b, n, h, 2 * D, dtype=torch.bfloat16)[..., ::2])  # head dim strided
    refused(torch.zeros(b, n, h, D + 4, dtype=torch.bfloat16)[..., :D])  # rows 8 B apart from 16 B alignment
    refused(bnhd(), k=bnhd(dtype=torch.float32))  # operands of two dtypes
    refused(torch.zeros(70000, 1, 1, D, dtype=torch.bfloat16))  # batch past the CUDA grid's 65535
    with pytest.raises(ValueError):  # the fused entry's qkv, rows 8 B off 16 B alignment
        fa._qkv_operands(torch.zeros(1, 4, 3 * 2 * D + 4, dtype=torch.bfloat16)[..., : 3 * 2 * D], D)


def test_kernel_bias_operand_strides_and_offset():
    """The (address, offset, strides) the kernel gets, from shapes and strides
    alone: a stack layer is an element offset into the stack, a broadcast dim
    has stride 0, a pre-padded bias keeps its padded row stride."""
    b, h, n = 2, 3, 37
    cpu = torch.device("cpu")
    stack = torch.zeros(4, h, 40, 40, dtype=torch.bfloat16)
    code, (addr, offset, *strides) = fa._bias_operand(None, stack, 2, b, h, n, cpu)
    assert (code, addr, offset, strides) == (1, stack.data_ptr(), 2 * h * 40 * 40, [0, 40 * 40, 40, 1])
    dense = torch.zeros(b, h, n, n)
    assert fa._bias_operand(dense, None, None, b, h, n, cpu) == (0, (dense.data_ptr(), 0, h * n * n, n * n, n, 1))
    col = torch.zeros(1, 1, n, 1)
    assert fa._bias_operand(col, None, None, b, h, n, cpu)[1][2:] == (0, 0, 1, 0)
    row = torch.zeros(1, n)
    assert fa._bias_operand(row, None, None, b, h, n, cpu)[1][2:] == (0, 0, 0, 1)
    assert fa._bias_operand(None, None, None, b, h, n, cpu) is fa._NO_BIAS
    half = torch.zeros(1, h, n, n, dtype=torch.float16)  # a float16 bias packs code 2
    assert fa._bias_operand(half, None, None, b, h, n, cpu) == (2, (half.data_ptr(), 0, 0, n * n, n, 1))
    for bad in ({"bias": torch.zeros(1, h, n, n, dtype=torch.float64)}, {"bias": torch.zeros(1, h, n, n, device="meta")},
                {"bias": torch.zeros(1, h, n - 1, n)}, {"bias_stack": stack, "layer": 4}):
        with pytest.raises(ValueError):
            fa._bias_operand(bad.get("bias"), bad.get("bias_stack"), bad.get("layer"), b, h, n, cpu)
