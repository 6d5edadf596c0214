"""The port's attention variant shootout (``muggled_dpt_tpu_torch/tools/attn_variants.py``,
TPU kernel #12): the entry on CPU tensors (its plain version) against the JAX
package's kernel bodies ``tools/attn_variants.py:_onepass_kernel`` and
``_innerloop_kernel``. The JAX ``flash_variant`` has no interpret switch and
so cannot run on the CPU; ``_jax_variant`` below wraps the same kernel
bodies in an interpret-mode ``pl.pallas_call`` with ``flash_variant``'s
padding, grid and BlockSpecs copied verbatim (``:140-160``). Every mode at
N=200 and N=300 and the chunked online softmax, within 3e-5 in float32.

The all-negative case (q > 0, k < 0, both scaled by 4, then by the softmax
scale and log2(e)) is pinned on both sides: ``mask_exp2`` stays within 2e-4
of float64 attention, while ``padfix`` and ``chunk`` are off by more than 1:
the pad keys' zero logits win the max, every real weight underflows, and the
pad-count correction cancels the whole row sum.

Then the entry's pointer and stride arithmetic through a stub of the kernel
library that reads ``enum Slot`` of ``csrc/flash_variants.cuh``."""

import array
import ctypes
import functools
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_variants as fv
from muggled_dpt_tpu_torch.tools import attn_variants as av
from tools import attn_variants as jav

TOL = dict(rtol=3e-5, atol=3e-5)
D = 64
SCALE_LOG2 = D**-0.5 * 1.4426950408889634
CUH = Path(fv.__file__).resolve().parents[2] / "csrc" / "flash_variants.cuh"


def _round_up(x, m):
    return (x + m - 1) // m * m


def _jax_variant(q, k, v, mode="padfix", block_q=128, chunk=None):
    """``tools/attn_variants.py:flash_variant`` with ``interpret=True``."""
    bh, n, d = q.shape
    n_pad_k = _round_up(n, 128)
    n_pad_q = _round_up(n, block_q)
    qp = jnp.pad(q, ((0, 0), (0, n_pad_q - n), (0, 0)))
    kp = jnp.pad(k, ((0, 0), (0, n_pad_k - n), (0, 0)))
    vp = jnp.pad(v, ((0, 0), (0, n_pad_k - n), (0, 0)))
    grid = (bh, n_pad_q // block_q)
    if chunk is None:
        kernel = functools.partial(jav._onepass_kernel, kv_len=n, mode=mode)
    else:
        kernel = functools.partial(jav._innerloop_kernel, kv_len=n, chunk=chunk)
    out = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[
            pl.BlockSpec((1, block_q, d), lambda b, i: (b, i, 0)),
            pl.BlockSpec((1, n_pad_k, d), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((1, n_pad_k, d), lambda b, i: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, block_q, d), lambda b, i: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, n_pad_q, d), q.dtype),
        interpret=True,
    )(qp, kp, vp)
    return np.asarray(out[:, :n, :])


def _inputs(rng, g, n, all_negative=False):
    """Pre-scaled q (by D^-0.5 log2(e), as the JAX tool's exp2 modes take it), k, v."""
    q, k, v = (rng.standard_normal((g, n, D)).astype(np.float32) for _ in range(3))
    if all_negative:
        q, k = (np.abs(q) + 0.5) * 4.0, -(np.abs(k) + 0.5) * 4.0
    return (q * np.float32(SCALE_LOG2)).astype(np.float32), k, v


def _port(q, k, v, **kw):
    return av.flash_variant(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()


def _exp2_attention(q, k, v):
    """float64 attention with base-2 weights: the exact answer of the exp2 modes."""
    s = np.einsum("gnd,gmd->gnm", q.astype(np.float64), k.astype(np.float64))
    p = np.exp2(s - s.max(axis=-1, keepdims=True))
    return np.einsum("gnm,gmd->gnd", p / p.sum(axis=-1, keepdims=True), v.astype(np.float64))


@pytest.mark.parametrize("n", [200, 300])
@pytest.mark.parametrize("mode", av.MODES)
def test_variant_matches_jax_kernel(mode, n):
    q, k, v = _inputs(np.random.default_rng(n), 2, n)
    want = _jax_variant(*(jnp.asarray(a) for a in (q, k, v)), mode=mode)
    got = _port(q, k, v, mode=mode, block_q=704)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * max(1.0, np.abs(want).max()))
    if mode in ("mask_exp2", "padfix"):
        np.testing.assert_allclose(got, _exp2_attention(q, k, v), **TOL)


@pytest.mark.parametrize("n,chunk", [(200, 128), (300, 128), (300, 64)])
def test_chunk_matches_jax_kernel(n, chunk):
    q, k, v = _inputs(np.random.default_rng(n + chunk), 2, n)
    want = _jax_variant(*(jnp.asarray(a) for a in (q, k, v)), chunk=chunk)
    got = _port(q, k, v, chunk=chunk)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _exp2_attention(q, k, v), **TOL)


@pytest.mark.parametrize("variant", [{"mode": "mask_exp2"}, {"mode": "padfix"}, {"chunk": 128}])
def test_all_negative_logits(variant):
    """mask_exp2 holds; padfix and chunk fail by more than 1 on both sides,
    the port's plain version equal to the JAX kernel's failure."""
    q, k, v = _inputs(np.random.default_rng(3), 2, 200, all_negative=True)
    true = _exp2_attention(q, k, v)
    want = _jax_variant(*(jnp.asarray(a) for a in (q, k, v)), **variant)
    got = _port(q, k, v, **variant)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if variant.get("mode") == "mask_exp2":
        np.testing.assert_allclose(got, true, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(want - true).max() > 1.0 and np.abs(got - true).max() > 1.0


def test_variant_entry_refuses_what_it_cannot_take():
    q, k, v = (torch.zeros(2, 40, D) for _ in range(3))
    with pytest.raises(ValueError):
        av.flash_variant(q, k, v, mode="softmax")
    with pytest.raises(ValueError):
        av.flash_variant(q, k, v, chunk=256)  # wider than the 128 padded keys
    with pytest.raises(ValueError):
        av.flash_variant(q, k[:, :20], v)
    fa.reset_launch_counts()
    av.flash_variant(q, k, v)
    assert fa.launch_counts()["variant"] == 0


def _slots() -> dict:
    """``enum Slot`` of csrc/flash_variants.cuh: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", CUH.read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


class StubLibrary:
    """Stands in for the kernel library: reads the int64 argument array as
    the C entry does, views q, k, v and out at their addresses with the
    strides given ((BH, N, 1, D): one head per batch), maps the slots back
    to a mode and a chunk, and writes the plain version into ``out``."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    @staticmethod
    def _view(addr, sizes, strides, dtype):
        extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
        buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)

    def mdpt_flash_variant(self, args_ptr, qk_scale, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        b, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_N", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        q, k, v, o = (self._view(a[s[k]], (b, n, h, d), [*a[s[k] + 1 : s[k] + 4], 1], dtype)[:, :, 0]
                      for k in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O"))
        call = {k: a[s[k]] for k in ("SLOT_HEADS", "SLOT_KEYS", "SLOT_MODE", "SLOT_CHUNK", "SLOT_PANEL")}
        self.calls.append(call)
        assert qk_scale == 1.0  # q comes pre-scaled
        mode = {code: name for name, code in fv.MODES.items()}[call["SLOT_MODE"]]
        n_pad = (n + 127) // 128 * 128
        chunk = call["SLOT_CHUNK"] if mode == "padfix" and call["SLOT_CHUNK"] != n_pad else None
        o.copy_(av.flash_variant_reference(q, k, v, mode, chunk))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    monkeypatch.setattr(fv, "array", types.SimpleNamespace(array=lambda code, v: array.array(code, [x or 0 for x in v])))
    monkeypatch.setattr(fv, "kernel_library", lambda: lib)
    monkeypatch.setattr(av, "_device_route", lambda device, name: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", [*({"mode": m} for m in av.MODES), {"chunk": 64}])
def test_variant_entry_arithmetic_through_stub_library(stub, dtype, variant):
    """Each mode's slots (keys taken, chunk, panel) and the (BH, N, D)
    strides read back by a stub that runs the plain version: the result
    equals the plain entry."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(rng, 3, 90))
    av.flash_variant.launches = 0
    got = av.flash_variant(q, k, v, block_q=1408, **variant)
    assert av.flash_variant.launches == 1 and len(stub.calls) == 1
    mode = variant.get("mode", "padfix")
    keys = {"mask_exp": 90, "mask_exp2": 90}.get(mode, 128)
    assert stub.calls[0]["SLOT_HEADS"] == 1 and stub.calls[0]["SLOT_KEYS"] == keys
    assert stub.calls[0]["SLOT_MODE"] == fv.MODES[mode]
    want = av.flash_variant_reference(q, k, v, mode, variant.get("chunk"))
    assert got.shape == want.shape == (3, 90, D) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
