"""The port's XL-N flash attention variants (``ops/kernels/flash_attention_xl.py``,
TPU kernel #10): the entry on CPU tensors (its plain version) against the
JAX package's ``experiments/flash_attention_xl.py`` in interpret mode, on the
same numpy inputs, every executable case of tests/test_flash_attention_xl.py
(the TPU-lowering cases have no counterpart). Tolerances as there: 3e-5 in
float32, 2e-4 where every logit is far below zero. Then the entry's pointer
and stride arithmetic through a stub of the kernel library that reads
``enum Slot`` of ``csrc/flash_variants.cuh``."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.flash_attention_xl import flash_attention_fused_qkv_xl as jax_xl
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_xl as xl
from muggled_dpt_tpu_torch.ops.kernels import flash_variants as fv

TOL = dict(rtol=3e-5, atol=3e-5)
NEG_TOL = dict(rtol=2e-4, atol=2e-4)
CUH = Path(fv.__file__).resolve().parents[2] / "csrc" / "flash_variants.cuh"


def _qkv(rng, b, n, h, d=64, all_negative=False):
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    if all_negative:  # q > 0, k < 0, both scaled by 4: every logit far below zero
        q, k = (np.abs(q) + 0.5) * 4.0, -(np.abs(k) + 0.5) * 4.0
    return np.stack([q, k, v], axis=3).reshape(b, n, 3 * h * d)


def _both(qkv, h, **kw):
    """(port entry on CPU, JAX kernel in interpret mode), each (B, N, C)."""
    want = np.asarray(jax_xl(jnp.asarray(qkv), h, interpret=True, **kw))
    port_kw = {k: v for k, v in kw.items() if k != "interpret"}
    got = xl.flash_attention_fused_qkv_xl(torch.from_numpy(qkv), h, **port_kw).numpy()
    return got, want


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("qp", [1, 2])
def test_xl_matches_jax(pipelined, qp):
    """n=700, block_q=256: dead q rows, pad-column masking and (qp=2) a q
    sub-block straddling the pad on the JAX side."""
    got, want = _both(_qkv(np.random.default_rng(7), 2, 700, 4), 4, block_q=256, qp=qp, pipelined=pipelined)
    np.testing.assert_allclose(got, want, **TOL)


def test_xl_hpp_override_matches_jax():
    got, want = _both(_qkv(np.random.default_rng(9), 1, 500, 8), 8, hpp=4, block_q=256, pipelined=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_xl_all_logits_negative():
    """The pad mask applies before the max: the real logits, all far below
    zero, never underflow against the pad keys."""
    got, want = _both(_qkv(np.random.default_rng(3), 1, 200, 2, all_negative=True), 2, block_q=128, qp=2, pipelined=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **NEG_TOL)


def test_xl_ablation_matches_jax():
    """The no-softmax ablation is a timing floor, not an attention: finite,
    of the right shape, and the JAX ablation's numbers (p = s * 1e-6, o = p v)."""
    qkv = _qkv(np.random.default_rng(5), 1, 300, 2)
    got, want = _both(qkv, 2, block_q=128, ablate_softmax=True)
    assert got.shape == (1, 300, 2 * 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bias_shape", [None, (1, 2, 1, 90), (2, 2, 90, 90)])
def test_plain_version_row_steps_change_no_result(monkeypatch, bias_shape):
    """#1's plain version (also #10's) takes query rows in steps so that its
    logits stay a few GB at the ladder's N; a step of 7 rows, a bias that
    broadcasts over rows and one that does not, agree with one step."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 90, 2, 64)).astype(np.float32)) for _ in range(3))
    bias = None if bias_shape is None else torch.from_numpy(rng.standard_normal(bias_shape).astype(np.float32))
    whole = fa.flash_attention_reference(q, k, v, bias)
    monkeypatch.setattr(fa, "REFERENCE_LOGITS", 2 * 2 * 90 * 7)
    assert fa.reference_row_step(2, 2, 90) == 7
    torch.testing.assert_close(fa.flash_attention_reference(q, k, v, bias), whole, rtol=1e-6, atol=1e-6)


def test_xl_entry_refuses_bad_qp_and_counts_no_cpu_launch():
    qkv = torch.from_numpy(_qkv(np.random.default_rng(1), 1, 40, 2))
    with pytest.raises(ValueError):
        xl.flash_attention_fused_qkv_xl(qkv, 2, qp=3)
    fa.reset_launch_counts()
    xl.flash_attention_fused_qkv_xl(qkv, 2, qp=4)
    assert fa.launch_counts()["xl"] == 0


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
    the C entry does, views the memory at each address with the strides it
    was given and writes into ``out`` what the mode computes (#1's plain
    version, or the ablation's), from q, k and v as viewed."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    @staticmethod
    def _view(addr, sizes, strides, dtype):
        extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
        buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)

    def mdpt_flash_attention_xl(self, args_ptr, qk_scale, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        b, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_N", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        q, k, v, o = (self._view(a[s[k]], (b, n, h, d), [*a[s[k] + 1 : s[k] + 4], 1], dtype)
                      for k in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O"))
        self.calls.append({k: a[s[k]] for k in ("SLOT_KEYS", "SLOT_MODE", "SLOT_QP", "SLOT_PIPELINED")})
        scale = qk_scale / fa.LOG2E
        if a[s["SLOT_MODE"]] == fv.MODES["ablate"]:
            qkv = torch.stack([q, k, v], dim=3).reshape(b, n, 3 * h * d)
            o.copy_(xl.ablation_reference(qkv, h, scale).reshape(b, n, h, d))
        else:
            o.copy_(fa.flash_attention_reference(q.float(), k.float(), v.float(), scale=scale).to(dtype))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    recorded = {}

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        recorded["values"] = [0 if x is None else x for x in values]
        return array.array(code, recorded["values"])

    monkeypatch.setattr(fv, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(fv, "kernel_library", lambda: lib)
    monkeypatch.setattr(xl, "_device_route", lambda device, name: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    lib.recorded = recorded
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qp,pipelined,ablate", [(1, True, False), (2, False, False), (4, True, True)])
def test_xl_entry_arithmetic_through_stub_library(stub, dtype, qp, pipelined, ablate):
    """q, k and v read in place in the slab (row stride 3C, head stride 3D),
    the output (B, N, C), the mode, qp and pipelining in their slots: the
    stub's result equals the plain entry."""
    qkv = torch.from_numpy(_qkv(np.random.default_rng(8), 2, 70, 3)).to(dtype)
    xl.flash_attention_fused_qkv_xl.launches = 0
    got = xl.flash_attention_fused_qkv_xl(qkv, 3, qp=qp, pipelined=pipelined, ablate_softmax=ablate, block_q=512, hpp=3)
    assert xl.flash_attention_fused_qkv_xl.launches == 1 and len(stub.calls) == 1
    assert len(stub.recorded["values"]) == stub.slots["NUM_SLOTS"]
    want_mode = fv.MODES["ablate" if ablate else "flash"]
    assert stub.calls[0] == {"SLOT_KEYS": 70, "SLOT_MODE": want_mode, "SLOT_QP": qp, "SLOT_PIPELINED": int(pipelined)}
    want = xl.flash_attention_fused_qkv_xl_reference(qkv, 3, ablate_softmax=ablate)
    assert got.shape == want.shape == (2, 70, 3 * 64) and got.dtype == dtype
    torch.testing.assert_close(got, want)  # the scale crosses as scale * log2(e): round-off only
