"""The port's int8-QK^T flash attention (``ops/kernels/flash_attention_int8.py``,
TPU kernels #6 and #7): the plain versions, which the entries run for CPU
tensors, against the JAX package's Pallas kernels in interpret mode
(``experiments/flash_attention_int8.py``) on the same numpy inputs, with
the gates of tests/test_flash_int8_experiment.py: 5e-5 against the JAX
kernel and against a float64 softmax over the same dequantized int8 logits,
0.05 (max) and 5e-3 (mean) against true attention, 2e-4 against true
attention where quantization is lossless. Then the entries' argument checks
and pointer, stride and scratch arithmetic through a stub of the kernel
library.

Tolerances: both sides compute the same exact integer logits times the same
float32 alpha; they differ in exp2 and in float32 summation order (the JAX
#6 kernel also rescales its online softmax per key block), hence 5e-5.
bfloat16: 2e-2, one bf16 ulp at outputs in [2, 4)."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.flash_attention_int8 import LOG2E, flash_attention_int8_qk, flash_attention_int8_qk_fused
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_int8 as fi8

TOL = dict(rtol=5e-5, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
D = 64
CU_SOURCE = Path(fi8.__file__).resolve().parents[2] / "csrc" / "flash_attention_int8.cu"


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def naive_attention(q, k, v, scale):
    """float64 softmax attention over the last two axes of (G, N, D) arrays."""
    s = np.einsum("gnd,gmd->gnm", q.astype(np.float64), k.astype(np.float64)) * scale
    p = np.exp(s - s.max(axis=2, keepdims=True))
    return np.einsum("gnm,gmd->gnd", p / p.sum(axis=2, keepdims=True), v.astype(np.float64))


def _bhnd(rng, b, n, h, all_negative=False):
    q, k, v = (rng.standard_normal((b, n, h, D)).astype(np.float32) for _ in range(3))
    if all_negative:  # every logit strongly negative
        q, k = -8.0 * np.abs(q), np.abs(k)
    return q, k, v


def _heads_first(x):
    """(B, N, H, D) -> (B H, N, D)."""
    b, n, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, n, d)


@pytest.mark.parametrize("n,block", [(700, 256), (300, 128)])  # ragged last key block
def test_online_plain_version_matches_jax_kernel(n, block):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((4, n, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(flash_attention_int8_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block, block_k=block,
                                              interpret=True))
    got = fi8.flash_attention_int8_qk_reference(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    true = naive_attention(q, k, v, D**-0.5)
    assert np.abs(got - true).max() < 5e-2 and np.abs(got - true).mean() < 5e-3
    # a CPU tensor takes the plain version through the entry
    torch.testing.assert_close(fi8.flash_attention_int8_qk(_t(q), _t(k), _t(v)), torch.from_numpy(got), rtol=0, atol=0)


def test_online_exact_when_quantization_is_lossless():
    """Rows whose max |entry| hits the scale anchor quantize exactly: with
    integer-grid inputs the only error left is float32 round-off."""
    rng = np.random.default_rng(1)
    qi, ki = (rng.integers(-127, 128, (2, 256, D)).astype(np.float32) for _ in range(2))
    qi[:, :, 0] = 127
    ki[:, :, 0] = 127
    q, k = qi * 0.02, ki * 0.02
    v = rng.standard_normal((2, 256, D)).astype(np.float32)
    got = fi8.flash_attention_int8_qk_reference(_t(q), _t(k), _t(v)).numpy()
    assert np.abs(got - naive_attention(q, k, v, D**-0.5)).max() < 2e-4
    want = flash_attention_int8_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("block_q", [None, 128])
def test_fused_plain_version_matches_jax_kernel(block_q):
    """#7 against the JAX one-pass kernel, a float64 softmax over the same
    dequantized int8 logits, and true attention."""
    rng = np.random.default_rng(3)
    b, n, h = 2, 300, 2
    q, k, v = _bhnd(rng, b, n, h)
    qkv = np.stack([q, k, v], axis=3).reshape(b, n, 3 * h * D)
    want = np.asarray(flash_attention_int8_qk_fused(jnp.asarray(qkv), h, interpret=True, block_q=block_q))
    got = fi8.flash_attention_int8_qk_fused_reference(_t(qkv), h).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    qf = q * (D**-0.5 * LOG2E)  # the wrapper's quantization, in numpy
    sq = np.maximum(np.abs(qf).max(axis=3), 1e-12) / 127.0
    sk = np.maximum(np.abs(k).max(axis=(1, 3)), 1e-12) / 127.0
    q_i8, k_i8 = np.round(qf / sq[..., None]), np.round(k / sk[:, None, :, None])
    logits2 = np.einsum("bnhd,bmhd->bhnm", q_i8, k_i8) * (sq.transpose(0, 2, 1) * sk[..., None])[..., None]
    w = np.exp2(logits2 - logits2.max(axis=-1, keepdims=True))
    ref_deq = np.einsum("bhnm,bmhd->bnhd", w / w.sum(axis=-1, keepdims=True), v.astype(np.float64))
    np.testing.assert_allclose(got.reshape(b, n, h, D), ref_deq, **TOL)
    true = naive_attention(_heads_first(q), _heads_first(k), _heads_first(v), D**-0.5)
    assert np.abs(_heads_first(got.reshape(b, n, h, D)) - true).max() < 5e-2


@pytest.mark.parametrize("fused", [False, True])
def test_all_negative_logits(fused):
    """Every logit far below zero (about -40), ragged N: the masked keys use
    -1e30, never a pad count, so the softmax stays finite and equal to the
    JAX kernel's. (Not gated against true attention: int8 logit error grows
    with the logits' size, 0.22 max here.)"""
    rng = np.random.default_rng(4)
    q, k, v = _bhnd(rng, 1, 200, 2, all_negative=True)
    if fused:
        qkv = np.stack([q, k, v], axis=3).reshape(1, 200, 3 * 2 * D)
        got = fi8.flash_attention_int8_qk_fused_reference(_t(qkv), 2).numpy()
        want = np.asarray(flash_attention_int8_qk_fused(jnp.asarray(qkv), 2, interpret=True))
        got, want = _heads_first(got.reshape(1, 200, 2, D)), _heads_first(want.reshape(1, 200, 2, D))
    else:
        q, k, v = _heads_first(q), _heads_first(k), _heads_first(v)
        got = fi8.flash_attention_int8_qk_reference(_t(q), _t(k), _t(v)).numpy()
        want = np.asarray(flash_attention_int8_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
                                                  interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_zero_query_row_gives_the_uniform_softmax():
    """A q row of zeros quantizes with sq = 1e-12 / 127 to q_i8 = 0: its
    logits are 0 and its output is the mean of v, not a NaN."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 100, D)).astype(np.float32) for _ in range(3))
    q[:, 7] = 0.0
    got = fi8.flash_attention_int8_qk_reference(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got[:, 7], v.mean(axis=1), rtol=1e-5, atol=1e-6)
    qkv = np.stack([q, k, v], axis=2).reshape(2, 100, 3 * D)  # one head
    got = fi8.flash_attention_int8_qk_fused_reference(_t(qkv), 1).numpy()
    np.testing.assert_allclose(got[:, 7], v.mean(axis=1), rtol=1e-5, atol=1e-6)


def test_fused_plain_version_matches_jax_kernel_bf16():
    """PV in bfloat16: p rounded to bf16 before the product and the row sum."""
    rng = np.random.default_rng(6)
    q, k, v = _bhnd(rng, 2, 150, 2)
    qkv = np.stack([q, k, v], axis=3).reshape(2, 150, 3 * 2 * D)
    want = flash_attention_int8_qk_fused(jnp.asarray(qkv, jnp.bfloat16), 2, interpret=True)
    got = fi8.flash_attention_int8_qk_fused_reference(_t(qkv, torch.bfloat16), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **BF16_TOL)


def test_cpu_calls_count_no_launch():
    fa.reset_launch_counts()
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal((2, 40, D))) for _ in range(3))
    fi8.flash_attention_int8_qk(q, k, v)
    fi8.flash_attention_int8_qk_fused(_t(rng.standard_normal((1, 40, 3 * D))), 1)
    counts = fa.launch_counts()
    assert all(counts[r] == 0 for r in ("int8_qk", "int8_qk_sm90", "int8_qk_fused", "int8_qk_fused_sm90"))


def test_kernel_launcher_refuses_what_it_cannot_take():
    """What the CUDA kernels cannot take raises before any launch: a head
    width other than 64, another dtype, a slab whose rows are not 16-byte
    aligned, q, k and v of different dtypes or shapes."""
    with pytest.raises(ValueError):  # D = 32
        fi8.prepare_int8_qk_fused(torch.zeros(1, 16, 3 * 2 * 32, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError):
        fi8.prepare_int8_qk_fused(torch.zeros(1, 16, 3 * D, dtype=torch.float16), 1)
    with pytest.raises(ValueError):  # rows 392 bytes apart: 8 B off 16 B alignment
        fi8.prepare_int8_qk_fused(torch.zeros(1, 16, 3 * D + 4, dtype=torch.bfloat16)[..., : 3 * D], 1)
    q = torch.zeros(2, 16, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fi8.prepare_int8_qk(q, q.float(), q)
    with pytest.raises(ValueError):
        fi8.prepare_int8_qk(q, q[:, :8], q[:, :8])
    with pytest.raises(ValueError):
        fi8.prepare_int8_qk(q.half(), q.half(), q.half())


def _slots() -> dict:
    """``enum Slot`` of csrc/flash_attention_int8.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", CU_SOURCE.read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


class StubLibrary:
    """Stands in for the kernel library: reads the int64 argument array as
    the C entry does, views the memory at each address with the strides it
    was given, runs the plain prologue (its float arguments rounded to
    float32, as ctypes passes them) into the scratch slots and the plain
    attention from them into ``out``, and writes the route to SLOT_ROUTE."""

    def __init__(self, slots):
        self.slots, self.calls = slots, 0

    @staticmethod
    def _view(addr, sizes, strides, dtype):
        extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
        buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)

    def mdpt_flash_attention_int8(self, args_ptr, q_mul, scale, stream):
        s = self.slots
        a = (ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr)
        b, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_N", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        q, k, v, o = (self._view(a[s[k]], (b, n, h, d), [*a[s[k] + 1 : s[k] + 4], 1], dtype)
                      for k in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O"))
        dense = (n * h * d, h * d, d, 1)
        q_i8, k_i8 = (self._view(a[s[k]], (b, n, h, d), dense, torch.int8) for k in ("SLOT_Q_I8", "SLOT_K_I8"))
        alpha = self._view(a[s["SLOT_ALPHA"]], (b, n, h), (h * n, 1, n), torch.float32)  # (B, H, N) in memory
        if a[s["SLOT_STAGES"]] & fi8.STAGE_PROLOGUE:
            qf, kf = q.float() * float(np.float32(q_mul)), k.float()
            sq = fi8._per_127(qf.abs().amax(dim=3).clamp_min(1e-12))
            sk = fi8._per_127(kf.abs().amax(dim=(1, 3)).clamp_min(1e-12))
            q_i8.copy_(torch.round(qf / sq[..., None]))
            k_i8.copy_(torch.round(kf / sk[:, None, :, None]))
            al = sq * sk[:, None, :]
            alpha.copy_(al if a[s["SLOT_MODE"]] == fi8.MODE_SQSK else al * float(np.float32(scale)) * LOG2E)
        if a[s["SLOT_STAGES"]] & fi8.STAGE_ATTENTION:
            o.copy_(fi8.int8_attention_reference(q_i8, k_i8, v, alpha))
        a[s["SLOT_ROUTE"]] = int(dtype == torch.bfloat16)
        self.calls += 1
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    recorded = {}

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        recorded["values"] = [0 if x is None else x for x in values]
        return array.array(code, recorded["values"])

    monkeypatch.setattr(fi8, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(fi8, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    lib.recorded = recorded
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_entry_arithmetic_through_stub_library(stub, dtype):
    """#7's addresses and strides (q, k and v read in place in the slab, the
    scratch and alpha as the C entry's slots name them), read back by a stub
    library that runs the plain version: the result equals the plain entry,
    and the call counts on its dtype's route."""
    rng = np.random.default_rng(8)
    qkv = _t(rng.standard_normal((2, 70, 3 * 3 * D)), dtype)
    fa.reset_launch_counts()
    got = fi8.flash_attention_int8_qk_fused(qkv, 3)
    routes = fa.launch_counts()
    assert (routes["int8_qk_fused_sm90"], routes["int8_qk_fused"]) == ((1, 0) if dtype == torch.bfloat16 else (0, 1))
    assert stub.calls == 1
    assert len(stub.recorded["values"]) == stub.slots["NUM_SLOTS"]
    want = fi8.flash_attention_int8_qk_fused_reference(qkv, 3)
    assert got.shape == want.shape == (2, 70, 3 * D) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_online_entry_arithmetic_through_stub_library(stub, dtype):
    rng = np.random.default_rng(9)
    q, k, v = (_t(rng.standard_normal((3, 90, D)), dtype) for _ in range(3))
    fa.reset_launch_counts()
    got = fi8.flash_attention_int8_qk(q, k, v, scale=0.2)
    routes = fa.launch_counts()
    assert (routes["int8_qk_sm90"], routes["int8_qk"]) == ((1, 0) if dtype == torch.bfloat16 else (0, 1))
    assert stub.calls == 1
    want = fi8.flash_attention_int8_qk_reference(q, k, v, scale=0.2)
    assert got.shape == want.shape == (3, 90, D) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
