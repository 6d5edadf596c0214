"""TPU kernel #12's sm_90 kernel (``csrc/flash_variant_sm90.cu``) without a
card:

* which kernel the C entry ``mdpt_flash_variant`` takes, through the stub
  transcription of ``variant_entry``'s choice that
  ``test_torch_flash_sm90_variants.py`` pins to the C text: every bf16 mode
  of the sweep goes to the sm_90 kernel with the keys its mode takes (N for
  the mask modes, N_pad for padfix and the ablations, the chunk cut for
  ``chunk=c``), float32 to ``fv_f32``, and a layout a tensor map cannot
  read is refused; and the C entry's map from the sweep's modes to the
  kernel's (``launch_sm90``), pinned to its text;
* the identity the kernel relies on for ``chunk=c``: the JAX
  ``_innerloop_kernel`` (a per-chunk pad correction inside an online
  softmax) equals padfix over the first K_end = (N_pad // c) c keys, the
  keys in [N, K_end) zero rows, with one correction max(0, K_end - N) 2^-m
  at the end. Held against the JAX kernel in interpret mode within 3e-5 in
  float32, both as one pass and in the kernel's own order (128-key tiles,
  a running max with rescaling, keys at or past K_end masked by index),
  where K_end > N, where K_end < N, and where K_end is no multiple of 128;
* the all-negative failure survives that form: the pad keys stay in the
  max and in l, so the correction cancels the row sum as the JAX kernel's
  does."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from muggled_dpt_tpu_torch.ops.kernels import flash_variants as fv
from muggled_dpt_tpu_torch.tools import attn_variants as av
from muggled_dpt_tpu_torch.tools import flash_tune as ft
from test_torch_flash_sm90_variants import _slots, c_entry_route
from tools import attn_variants as jav

CSRC = Path(fv.__file__).resolve().parents[2] / "csrc"
D = 64
SCALE_LOG2 = D**-0.5 * 1.4426950408889634
TOL = 3e-5
# (N, c): K_end = (N_pad // c) c past N and no multiple of 128; past N; below N and no multiple of 128; below N
CHUNK_CASES = [(300, 176), (1297, 352), (250, 96), (1300, 400)]


def _round_up(x, m):
    return (x + m - 1) // m * m


def _inputs(rng, g, n, all_negative=False):
    """Pre-scaled q (by D^-0.5 log2(e)), k, v, as numpy float32."""
    q, k, v = (rng.standard_normal((g, n, D)).astype(np.float32) for _ in range(3))
    if all_negative:
        q, k = (np.abs(q) + 0.5) * 4.0, -(np.abs(k) + 0.5) * 4.0
    return (q * np.float32(SCALE_LOG2)).astype(np.float32), k, v


def _jax_innerloop(q, k, v, chunk):
    """The JAX ``_innerloop_kernel`` in an interpret-mode ``pl.pallas_call``
    with ``flash_variant``'s padding, one q block of all rows."""
    g, n, d = q.shape
    n_pad = _round_up(n, 128)
    block_q = _round_up(n, 8)
    qp = jnp.pad(jnp.asarray(q), ((0, 0), (0, block_q - n), (0, 0)))
    kp, vp = (jnp.pad(jnp.asarray(a), ((0, 0), (0, n_pad - n), (0, 0))) for a in (k, v))
    out = pl.pallas_call(
        functools.partial(jav._innerloop_kernel, kv_len=n, chunk=chunk),
        grid=(g, 1),
        in_specs=[pl.BlockSpec((1, block_q, d), lambda b, i: (b, i, 0)),
                  pl.BlockSpec((1, n_pad, d), lambda b, i: (b, 0, 0)),
                  pl.BlockSpec((1, n_pad, d), lambda b, i: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, block_q, d), lambda b, i: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((g, block_q, d), q.dtype),
        interpret=True,
    )(qp, kp, vp)
    return np.asarray(out[:, :n])


def _keys(k, v, n, kend):
    """k and v over the first kend keys, rows at or past N zero (TMA's zero fill)."""
    kz, vz = (np.zeros((a.shape[0], max(kend, n), D), np.float64) for a in (k, v))
    kz[:, :n], vz[:, :n] = k, v
    return kz[:, :kend], vz[:, :kend]


def one_correction(q, k, v, n, kend):
    """padfix over the first kend keys, one pass: the max and the row sum
    over every one of them, then l -= max(0, kend - N) 2^-m."""
    kz, vz = _keys(k, v, n, kend)
    s = np.einsum("gnd,gmd->gnm", q.astype(np.float64), kz)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp2(s - m)
    l = p.sum(axis=-1, keepdims=True) - max(0, kend - n) * np.exp2(-m)
    return np.einsum("gnm,gmd->gnd", p, vz) / np.maximum(l, 1e-30)


def tiled_one_correction(q, k, v, n, kend, tile=128):
    """The same in the sm_90 kernel's order: 128-key tiles, keys at or past
    kend masked by index (out of the max, p = 0), a running max m with l and
    the accumulator rescaled by 2^(m_old - m_new), the correction once after
    the last tile."""
    kz, vz = _keys(k, v, n, _round_up(kend, tile))
    q = q.astype(np.float64)
    m = np.full(q.shape[:2] + (1,), -1e30)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape)
    for t0 in range(0, kend, tile):
        s = np.einsum("gnd,gmd->gnm", q, kz[:, t0:t0 + tile])
        live = np.arange(t0, t0 + tile) < kend
        m_new = np.maximum(m, np.where(live, s, -np.inf).max(axis=-1, keepdims=True))
        alpha = np.exp2(m - m_new)
        p = np.where(live, np.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(axis=-1, keepdims=True)
        acc = acc * alpha + np.einsum("gnm,gmd->gnd", p, vz[:, t0:t0 + tile])
        m = m_new
    if kend > n:
        l = l - (kend - n) * np.exp2(-m)
    return acc / np.maximum(l, 1e-30)


def _kend(n, chunk):
    return _round_up(n, 128) // chunk * chunk


@pytest.mark.parametrize("form", [one_correction, tiled_one_correction], ids=["one pass", "128-key tiles"])
@pytest.mark.parametrize("n,chunk", CHUNK_CASES)
def test_chunk_equals_padfix_over_kend_keys_with_one_correction(n, chunk, form):
    q, k, v = _inputs(np.random.default_rng(n + chunk), 2, n)
    want = _jax_innerloop(q, k, v, chunk)
    got = form(q, k, v, n, _kend(n, chunk))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()))


def test_chunk_cases_cover_the_kend_edges():
    kends = [(n, _kend(n, c)) for n, c in CHUNK_CASES]
    assert any(ke > n and ke % 128 for n, ke in kends)
    assert any(ke < n and ke % 128 for n, ke in kends)
    assert any(ke > n and ke % 128 == 0 for n, ke in kends)


@pytest.mark.parametrize("chunk", [128, 176])
def test_all_negative_failure_survives_the_one_correction(chunk):
    """Every real logit far below 0: the pad keys win the max, the real
    weights underflow and the correction cancels the row sum, in the JAX
    kernel and in the kernel's form alike: both miss the true attention by
    more than 1, and by the same amount."""
    n = 200
    q, k, v = _inputs(np.random.default_rng(3), 2, n, all_negative=True)
    s = np.einsum("gnd,gmd->gnm", q.astype(np.float64), k.astype(np.float64))
    p = np.exp2(s - s.max(axis=-1, keepdims=True))
    true = np.einsum("gnm,gmd->gnd", p / p.sum(axis=-1, keepdims=True), v)
    want = _jax_innerloop(q, k, v, chunk)
    got = tiled_one_correction(q, k, v, n, _kend(n, chunk))
    assert np.abs(want - true).max() > 1.0 and np.abs(got - true).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_plain_chunk_version_equals_the_one_correction_form():
    """The port's plain version of chunk=c (the JAX chunk loop) equals the
    kernel's form in float32 within the same tolerance."""
    for n, chunk in CHUNK_CASES:
        q, k, v = _inputs(np.random.default_rng(n), 2, n)
        got = av.flash_variant_reference(*(torch.from_numpy(a) for a in (q, k, v)), "padfix", chunk).numpy()
        want = tiled_one_correction(q, k, v, n, _kend(n, chunk))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()))


# flash_variant.cu's launch_sm90, whitespace collapsed: each #12 mode's kernel mode and scale
C_MODES = ("case MODE_MASK_EXP: fv_mode = FV_MASK, scale_log2 = a.qk_scale * LOG2E; break; "
           "case MODE_MASK_EXP2: fv_mode = FV_MASK; break; case MODE_PADFIX: fv_mode = FV_PADFIX; break; "
           "case MODE_NOSM: fv_mode = FV_NOSM; break; case MODE_EXPONLY: fv_mode = FV_EXPONLY; break; "
           "case MODE_MAXONLY: fv_mode = FV_MAXONLY; break; default: return cudaErrorInvalidValue;")
FV_MODES = {"FV_MASK": 0, "FV_PADFIX": 1, "FV_NOSM": 2, "FV_EXPONLY": 3, "FV_MAXONLY": 4}


def test_c_entry_maps_every_mode_to_the_sm90_kernel():
    """Every #12 mode has its kernel mode, with mask_exp's natural exp as
    exp2 of the logit times log2(e); the two sources agree on FvMode's values."""
    entry = " ".join((CSRC / "flash_variant.cu").read_text().split())
    assert C_MODES in entry
    assert "constexpr int FV_MASK = 0, FV_PADFIX = 1, FV_NOSM = 2, FV_EXPONLY = 3, FV_MAXONLY = 4;" in entry
    kernel = " ".join((CSRC / "flash_variant_sm90.cu").read_text().split())
    assert "enum FvMode { FV_MASK = 0, FV_PADFIX = 1, FV_NOSM = 2, FV_EXPONLY = 3, FV_MAXONLY = 4 };" in kernel
    for mode in ("mask_exp", "mask_exp2", "padfix", "nosm", "maxonly", "exponly"):
        assert f"case MODE_{mode.upper()}:" in C_MODES


def _args(slots, dtype_code, n, keys, mode, q_addr=4096, row=64):
    s = slots
    a = [0] * s["NUM_SLOTS"]
    for slot in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O"):
        a[s[slot]:s[slot] + 4] = [q_addr, n * row, row, row]
    a[s["SLOT_BATCH"]], a[s["SLOT_N"]], a[s["SLOT_KEYS"]], a[s["SLOT_HEADS"]] = 16, n, keys, 1
    a[s["SLOT_HEAD_DIM"]], a[s["SLOT_DTYPE"]], a[s["SLOT_MODE"]] = D, dtype_code, fv.MODES[mode]
    return a


@pytest.mark.parametrize("n", [1297, 18497])
@pytest.mark.parametrize("case,kw", ft.VARIANT_CASES)
def test_every_bf16_mode_takes_the_sm90_kernel(case, kw, n):
    """bf16 at the sweep's shapes in every mode (its keys as the wrapper
    passes them) -> sm90; the same launch in float32 -> fv_f32; a base off
    16 bytes or a row stride off 8 elements -> refused."""
    slots = _slots()
    n_pad = _round_up(n, 128)
    mode = kw.get("mode", "padfix")
    keys = n if mode.startswith("mask") else n_pad // kw["chunk"] * kw["chunk"] if "chunk" in kw else n_pad
    assert c_entry_route(slots, _args(slots, 1, n, keys, mode), "mdpt_flash_variant") == "sm90"
    assert c_entry_route(slots, _args(slots, 0, n, keys, mode), "mdpt_flash_variant") == "fv_f32"
    assert c_entry_route(slots, _args(slots, 1, n, keys, mode, q_addr=4098), "mdpt_flash_variant") is None
    assert c_entry_route(slots, _args(slots, 1, n, keys, mode, row=68), "mdpt_flash_variant") is None


def test_wrapper_keys_per_mode_match_the_kernels_function():
    """The wrapper's keys for each mode are those the kernel's function
    takes: the chunk cut for chunk=c, N_pad for padfix and the ablations."""
    assert re.search(r'kw = \{"mode": "padfix", "keys": n_pad // chunk \* chunk, "chunk": chunk\}',
                     Path(av.__file__).read_text())
