"""The unbiased attention launches that csrc/flash_attention_sm90.cu computes
(TPU kernels #1 and #5, and #4's unbiased launches), on the CPU: no card,
nvcc or triton needed.

1. #1's and #5's plain versions (the wrappers' CPU route) against the JAX
   package's Pallas kernels in interpret mode at the new kernel's tile
   edges (N = 127, 129, 257 straddle its 128-row q tiles and 128-key K/V
   tiles). Tolerance: atol = rtol = 2e-5 in float32, as in
   tests/test_torch_attention.py: the two differ only in float32
   summation order and exp vs exp2.
2. What TMA cannot take (a base or a stride that is not 16-byte aligned, a
   head dim that is not contiguous) raises ValueError in both entries
   before any launch.
3. A stub of the kernel library reads the int64 argument array as the C
   entry does (``enum Slot`` of csrc/flash_attention.cu), checks
   that every base and stride is what a tensor map takes, and runs the plain
   version into ``out``: the fused slab at DA widths and (B, N, H, D) views
   reach it with the right strides and reproduce the plain version exactly."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from muggled_dpt_tpu.ops.pallas.flash_attention import _flash_bhnd_prescaled
from muggled_dpt_tpu.ops.pallas.flash_attention import flash_attention_fused_qkv as jax_fused_qkv
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)
D = 64
HEADS = 16  # DA-V2 ViT-L: C = 1024
CU_SOURCE = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
TILE_EDGES = (127, 129, 257)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("n", TILE_EDGES)
def test_fused_plain_version_matches_jax_kernel_at_tile_edges(n):
    """#1: the fused entry's plain version, through the CPU wrapper too."""
    qkv = _rand(n, 2, n, 2 * 3 * D)
    want = np.asarray(jax_fused_qkv(qkv, 2, interpret=True))
    np.testing.assert_allclose(fa.flash_attention_fused_qkv_reference(_t(qkv), 2).numpy(), want, **TOL)
    np.testing.assert_allclose(fa.flash_attention_fused_qkv(_t(qkv), 2).numpy(), want, **TOL)


@pytest.mark.parametrize("n", TILE_EDGES)
def test_bnhd_plain_version_matches_jax_online_kernel_at_tile_edges(n):
    """#5: the (B, N, H, D) entry against the JAX streamed-key kernel, forced
    with one_pass=False, at H=2 as #5 runs."""
    q, k, v = (_rand(10 * n + i, 1, n, 2, D) for i in range(3))
    heads_first = lambda x: x.transpose(0, 2, 1, 3).reshape(2, n, D)  # noqa: E731
    want = np.asarray(_flash_bhnd_prescaled(heads_first(q) * D**-0.5, heads_first(k), heads_first(v), None, interpret=True,
                                            one_pass=False))
    got = fa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(heads_first(got), want, **TOL)


def _slots() -> dict:
    """``enum Slot`` of csrc/flash_attention.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", CU_SOURCE.read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


class StubLibrary:
    """Stands in for the kernel library's ``mdpt_flash_attention``: reads
    the argument array as the C entry does, requires of every operand what
    the tensor maps of an unbiased bf16 launch require (16-byte aligned
    address and byte strides), views the memory at each address with its
    strides and runs the plain version into ``out``."""

    def __init__(self, slots):
        self.slots, self.calls, self.operands = slots, 0, {}

    @staticmethod
    def _view(addr, sizes, strides, dtype):
        extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
        buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)

    def mdpt_flash_attention(self, args_ptr, scale_log2, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        b, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_N", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype = [torch.float32, torch.bfloat16, torch.float16][a[s["SLOT_DTYPE"]]]
        assert a[s["SLOT_BIAS_DTYPE"]] == -1 and d == D
        es = torch.empty((), dtype=dtype).element_size()
        views = []
        for name in ("Q", "K", "V", "O"):
            addr, *strides = a[s[f"SLOT_{name}"] : s[f"SLOT_{name}"] + 4]
            assert addr % 16 == 0 and all(st * es % 16 == 0 for st in strides), (name, addr, strides)
            self.operands[name] = (addr, tuple(strides))
            views.append(self._view(addr, (b, n, h, d), [*strides, 1], dtype))
        q, k, v, o = views
        o.copy_(fa.flash_attention_reference(q, k, v, scale=scale_log2 / fa.LOG2E))
        self.calls += 1
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        return array.array(code, [0 if x is None else x for x in values])

    monkeypatch.setattr(fa, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(fa, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _split(qkv, h):
    x = qkv.unflatten(2, (h, 3, D))
    return x[..., 0, :], x[..., 1, :], x[..., 2, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_slab_at_da_widths_through_stub_library(stub, dtype):
    """DA-V2 ViT-L's slab (16 heads, 3C = 3072) at B=2, N=129: q, k and v
    read in place at columns h 3D, + D and + 2D, rows 3C apart."""
    b, n = 2, 129
    qkv = _t(_rand(1, b, n, HEADS * 3 * D), dtype)
    fa.reset_launch_counts()
    got = fa.flash_attention_fused_qkv(qkv, HEADS)
    assert fa.launch_counts()["fused"] == 1 and stub.calls == 1
    es, ptr, c3 = qkv.element_size(), qkv.data_ptr(), 3 * HEADS * D
    assert stub.operands["Q"] == (ptr, (n * c3, c3, 3 * D))
    assert stub.operands["K"] == (ptr + D * es, (n * c3, c3, 3 * D))
    assert stub.operands["V"] == (ptr + 2 * D * es, (n * c3, c3, 3 * D))
    assert stub.operands["O"] == (got.data_ptr(), (n * HEADS * D, HEADS * D, D))
    want = fa.flash_attention_reference(*_split(qkv, HEADS)).reshape(b, n, HEADS * D)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, fa.flash_attention_fused_qkv_reference(qkv, HEADS), rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["slab views", "heads-first transpose", "contiguous"])
@pytest.mark.parametrize("b", [1, 8])
def test_bnhd_views_through_stub_library(stub, layout, b):
    """The (B, N, H, D) entry on strided views at N=129: views of one qkv
    slab, a (B, H, N, D) tensor seen as (B, N, H, D) (head stride past the
    row stride), and contiguous tensors; each operand keeps its own strides."""
    n, h = 129, 4
    qkv = _t(_rand(2 + b, b, n, h * 3 * D), torch.bfloat16)
    q, k, v = _split(qkv, h)
    if layout == "heads-first transpose":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    elif layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, scale=0.125)
    assert fa.launch_counts()["bnhd"] == 1 and stub.calls == 1
    for name, t in (("Q", q), ("K", k), ("V", v)):
        assert stub.operands[name] == (t.data_ptr(), t.stride()[:3])
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v, scale=0.125), rtol=0, atol=0)


def _unaligned_bnhd():
    """(B, N, H, D) operands each breaking one rule of TMA, with the rule."""
    b, n, h = 2, 16, 2
    bf16 = dict(dtype=torch.bfloat16)
    return {
        "base 8 B off 16 B": torch.zeros(b, n, h, D + 8, **bf16)[..., 4 : 4 + D],
        "head stride 136 B": torch.zeros(b, n, h, D + 4, **bf16)[..., :D],
        "row stride 8 B off": torch.zeros(b, n, h * D + 4, **bf16)[..., : h * D].unflatten(2, (h, D)),
        "batch stride 8 B off": torch.zeros(b * (n * h * D + 4), **bf16).as_strided((b, n, h, D), (n * h * D + 4, h * D, D, 1)),
        "head dim strided": torch.zeros(b, n, h, 2 * D, **bf16)[..., ::2],
    }


@pytest.mark.parametrize("case", list(_unaligned_bnhd()))
def test_bnhd_entry_refuses_what_tma_cannot_take(stub, case):
    bad = _unaligned_bnhd()[case]
    good = torch.zeros(bad.shape, dtype=torch.bfloat16)
    for q, k, v in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v)
    assert stub.calls == 0


@pytest.mark.parametrize("case", ["base 8 B off 16 B", "row stride 8 B off", "batch stride 8 B off", "last dim strided"])
def test_fused_entry_refuses_what_tma_cannot_take(stub, case):
    b, n, c3 = 2, 16, 3 * 2 * D
    qkv = {
        "base 8 B off 16 B": lambda: torch.zeros(b, n, c3 + 8, dtype=torch.bfloat16)[..., 4 : 4 + c3],
        "row stride 8 B off": lambda: torch.zeros(b, n, c3 + 4, dtype=torch.bfloat16)[..., :c3],
        "batch stride 8 B off": lambda: torch.zeros(b * n * c3 + 4, dtype=torch.bfloat16).as_strided((b, n, c3), (n * c3 + 4, c3, 1)),
        "last dim strided": lambda: torch.zeros(b, n, 2 * c3, dtype=torch.bfloat16)[..., ::2],
    }[case]()
    with pytest.raises(ValueError):
        fa.flash_attention_fused_qkv(qkv, 2)
    assert stub.calls == 0
