"""The port's fused-qkv attention (plain version, which the wrapper runs for
CPU tensors) against the JAX package's Pallas kernel in interpret mode, on
the same numpy head-major qkv.

Tolerance: atol = rtol = 2e-5 in float32, as the JAX package holds its own
fused-qkv kernel to its naive reference (tests/test_flash_attention.py): the
two differ only in float32 summation order and exp vs exp2."""

import numpy as np
import pytest
import torch

from muggled_dpt_tpu.ops.pallas.flash_attention import flash_attention_fused_qkv as jax_fused_qkv
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, n, h, d, all_negative=False):
    x = np.random.default_rng(seed).standard_normal((b, n, h, 3, d), dtype=np.float32)
    if all_negative:  # every logit strongly negative: q = -8|x|, k = |y|
        x[..., 0, :] = -8.0 * np.abs(x[..., 0, :])
        x[..., 1, :] = np.abs(x[..., 1, :])
    return x.reshape(b, n, 3 * h * d)


def _jax(qkv_np, h, scale=None):
    return np.asarray(jax_fused_qkv(qkv_np, h, scale=scale, interpret=True))


@pytest.mark.parametrize("b,n,h,d", [(2, 200, 2, 64), (1, 130, 4, 64)])
def test_reference_matches_jax_kernel(b, n, h, d):
    qkv = _qkv(0, b, n, h, d)
    got = fa.flash_attention_fused_qkv_reference(torch.from_numpy(qkv), h).numpy()
    np.testing.assert_allclose(got, _jax(qkv, h), **TOL)


def test_reference_custom_scale():
    qkv = _qkv(1, 1, 100, 2, 64)
    got = fa.flash_attention_fused_qkv_reference(torch.from_numpy(qkv), 2, scale=0.5).numpy()
    np.testing.assert_allclose(got, _jax(qkv, 2, scale=0.5), **TOL)


def test_reference_all_logits_negative():
    """n=130 leaves a ragged tail; every real logit is far below zero, the
    case an analytic pad-count correction gets wrong."""
    qkv = _qkv(2, 1, 130, 2, 64, all_negative=True)
    got = fa.flash_attention_fused_qkv_reference(torch.from_numpy(qkv), 2).numpy()
    np.testing.assert_allclose(got, _jax(qkv, 2), **TOL)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    qkv = torch.from_numpy(_qkv(3, 2, 70, 2, 64))
    before = fa.launch_counts()["fused"]
    got = fa.flash_attention_fused_qkv(qkv, 2)
    assert fa.launch_counts()["fused"] == before == 0
    torch.testing.assert_close(got, fa.flash_attention_fused_qkv_reference(qkv, 2), rtol=0, atol=0)
    assert got.shape == (2, 70, 128) and got.dtype == torch.float32


ROUTES = ["fused", "fused_biased", "bnhd", "window", "window_sm90", "fused_f16", "fused_biased_f16", "bnhd_f16",
          "window_f16", "window_sm90_f16", "fused_mlp", "fused_mlp_sm90", "head_tail", "head_tail_sm90", "int8_qk",
          "int8_qk_sm90", "int8_qk_fused", "int8_qk_fused_sm90", "xl", "staged", "variant", "upsample_ac",
          "upsample_ac_nchw", "cosine_qk", "postnorm_residual", "swiglu_gate"]


def test_launch_counts_report_every_route_in_order():
    """``launch_counts()`` (which the benchmark logs) holds the 26 routes in
    this order, zeros included; counting a name it lacks raises."""
    fa.reset_launch_counts()
    assert list(fa.launch_counts()) == ROUTES and not any(fa.launch_counts().values())
    _build.count("xl")
    assert [r for r, n in fa.launch_counts().items() if n] == ["xl"]
    with pytest.raises(KeyError):
        _build.count("fused_bias")
    assert list(fa.launch_counts()) == ROUTES
    fa.reset_launch_counts()


def test_cpu_wrapper_keeps_bf16_dtype():
    qkv = torch.from_numpy(_qkv(4, 1, 33, 2, 64)).to(torch.bfloat16)
    got = fa.flash_attention_fused_qkv(qkv, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 33, 128)
    assert fa.launch_counts()["fused"] == 0


def test_wrapper_rejects_bad_shape_and_device():
    with pytest.raises(ValueError):
        fa.flash_attention_fused_qkv(torch.zeros(1, 10, 100), 2)  # 100 not a multiple of 3 * heads
    with pytest.raises(ValueError):
        fa.flash_attention_fused_qkv(torch.zeros(1, 10, 384, device="meta"), 2)
