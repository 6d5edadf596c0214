"""The port's staged (key-panel) flash attention (``ops/kernels/flash_attention_staged.py``,
TPU kernel #11): the port's ``_panel_bounds`` against the JAX function, and
the entry on CPU tensors (its plain version) against the JAX package's
``experiments/flash_attention_staged.py`` in interpret mode on the same numpy
inputs: every executable case of tests/test_flash_staged_experiment.py (the
TPU-lowering cases have no counterpart), the D=128 case on the plain version.
Tolerances as there: 3e-5 in float32, 2e-4 where every logit is far below
zero. Then the entry's pointer and stride arithmetic through a stub of the
kernel library that reads ``enum Slot`` of ``csrc/flash_variants.cuh`` and
takes the C entry's route (``test_torch_flash_sm90_variants.c_entry_route``)."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.flash_attention_staged import _panel_bounds as jax_panel_bounds
from experiments.flash_attention_staged import flash_attention_fused_qkv_staged as jax_staged
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_staged as st
from muggled_dpt_tpu_torch.ops.kernels import flash_variants as fv
from test_torch_flash_sm90_variants import CUDA_ERROR_INVALID_VALUE, c_entry_route

TOL = dict(rtol=3e-5, atol=3e-5)
NEG_TOL = dict(rtol=2e-4, atol=2e-4)
CUH = Path(fv.__file__).resolve().parents[2] / "csrc" / "flash_variants.cuh"


def _qkv(rng, b, n, h, d=64, all_negative=False):
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    if all_negative:  # q > 0, k < 0, both scaled by 4: every logit far below zero
        q, k = (np.abs(q) + 0.5) * 4.0, -(np.abs(k) + 0.5) * 4.0
    return np.stack([q, k, v], axis=3).reshape(b, n, 3 * h * d)


def _both(qkv, h, **kw):
    """(port entry on CPU, JAX kernel in interpret mode), each (B, N, C);
    the JAX kernel's VMEM tactics ``block_q`` and ``hpp`` go to it alone."""
    want = np.asarray(jax_staged(jnp.asarray(qkv), h, interpret=True, **kw))
    port_kw = {k: v for k, v in kw.items() if k not in ("block_q", "hpp")}
    got = st.flash_attention_fused_qkv_staged(torch.from_numpy(qkv), h, **port_kw).numpy()
    return got, want


@pytest.mark.parametrize("n_pad,panels", [(1024, 1), (1024, 2), (1280, 2), (1408, 3), (128, 4), (5504, 4), (10496, 8),
                                          (18560, 6), (18560, 8), (2944, 1)])
def test_panel_bounds_match_jax(n_pad, panels):
    got = st._panel_bounds(n_pad, panels)
    assert got == jax_panel_bounds(n_pad, panels)
    assert got[0] == 0 and got[-1] == n_pad and all(x % 128 == 0 for x in got)
    assert all(got[i] < got[i + 1] for i in range(len(got) - 1))


@pytest.mark.parametrize("hpp", [None, 2, 4])
@pytest.mark.parametrize("panels", [1, 3])
def test_staged_matches_jax(hpp, panels):
    """n=300 -> 384 padded keys: the pad mask live in the last panel."""
    got, want = _both(_qkv(np.random.default_rng(7), 2, 300, 4), 4, hpp=hpp, panels=panels)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n,block_q", [(700, 256), (500, 384)])
def test_staged_q_blocked_matches_jax(n, block_q):
    """The JAX side q-blocked (dead q rows, panels cutting across the pad);
    the port ignores block_q."""
    got, want = _both(_qkv(np.random.default_rng(11), 2, n, 2), 2, block_q=block_q, panels=4)
    np.testing.assert_allclose(got, want, **TOL)


def test_staged_all_logits_negative():
    got, want = _both(_qkv(np.random.default_rng(3), 1, 200, 2, all_negative=True), 2, panels=2)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **NEG_TOL)


def test_staged_d128_plain_version():
    """D = 128 (the JAX kernel's separate per-panel row sums); the CUDA
    kernel takes D = 64 only, the plain version any D."""
    got, want = _both(_qkv(np.random.default_rng(5), 1, 260, 2, d=128), 2, panels=2)
    np.testing.assert_allclose(got, want, **TOL)


def test_staged_output_does_not_depend_on_panels():
    """Panels change the order of the row sums only: float32 round-off."""
    qkv = torch.from_numpy(_qkv(np.random.default_rng(12), 1, 640, 2))
    outs = [st.flash_attention_fused_qkv_staged(qkv, 2, panels=p) for p in (1, 2, 4, 8)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(outs[0], fa.flash_attention_fused_qkv_reference(qkv, 2), **TOL)


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
    was given and writes the staged plain version of q, k and v as viewed
    into ``out``."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    @staticmethod
    def _view(addr, sizes, strides, dtype):
        extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
        buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)

    def mdpt_flash_attention_staged(self, args_ptr, qk_scale, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        b, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_N", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        q, k, v, o = (self._view(a[s[k]], (b, n, h, d), [*a[s[k] + 1 : s[k] + 4], 1], dtype)
                      for k in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O"))
        panel = a[s["SLOT_PANEL"]]
        route = c_entry_route(s, a, "mdpt_flash_attention_staged")  # the kernel the C entry takes
        self.calls.append({"route": route, **{k: a[s[k]] for k in ("SLOT_KEYS", "SLOT_MODE", "SLOT_QP", "SLOT_PANEL")}})
        if route is None:
            return CUDA_ERROR_INVALID_VALUE
        n_pad = (n + 127) // 128 * 128
        panels = -(-n_pad // panel)  # the panel count whose _panel_bounds has this width
        assert st._panel_bounds(n_pad, panels)[1] == panel
        qkv = torch.stack([q, k, v], dim=3).reshape(b, n, 3 * h * d)
        o.copy_(st.flash_attention_fused_qkv_staged_reference(qkv, h, qk_scale / fa.LOG2E, panels).reshape(b, n, h, d))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    monkeypatch.setattr(fv, "array", types.SimpleNamespace(array=lambda code, v: array.array(code, [x or 0 for x in v])))
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(st, "_device_route", lambda device, name: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,panels", [(70, 1), (300, 2), (700, 4)])
def test_staged_entry_arithmetic_through_stub_library(stub, dtype, n, panels):
    """q, k and v read in place in the slab, the panel width of
    ``_panel_bounds`` in its slot, the route the C entry takes (bf16: the
    sm_90 kernel; f32: fv_f32): the stub's result equals the plain entry."""
    qkv = torch.from_numpy(_qkv(np.random.default_rng(8), 2, n, 3)).to(dtype)
    fa.reset_launch_counts()
    got = st.flash_attention_fused_qkv_staged(qkv, 3, panels=panels)
    assert fa.launch_counts()["staged"] == 1 and len(stub.calls) == 1
    bounds = st._panel_bounds((n + 127) // 128 * 128, panels)
    want_route = "sm90" if dtype == torch.bfloat16 else "fv_f32"  # bf16: the wgmma/TMA kernel of csrc/flash_staged_sm90.cu
    assert stub.calls[0] == {"route": want_route, "SLOT_KEYS": n, "SLOT_MODE": fv.MODES["staged"], "SLOT_QP": 1,
                             "SLOT_PANEL": bounds[1]}
    want = st.flash_attention_fused_qkv_staged_reference(qkv, 3, panels=panels)
    assert got.shape == want.shape == (2, n, 3 * 64) and got.dtype == dtype
    torch.testing.assert_close(got, want)  # the scale crosses as scale * log2(e): round-off only
