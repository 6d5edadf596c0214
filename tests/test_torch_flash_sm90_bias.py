"""The biased bf16 attention launches that csrc/flash_attention_sm90.cu
computes since its bias operand (TPU kernels #2 and #4's biased launches),
on the CPU: no card, nvcc or triton needed.

1. #2's and #4's plain versions (the wrappers' CPU route) against the JAX
   package's Pallas kernels in interpret mode, with a bias, at the kernel's
   tile edges (N = 127-257 straddle its 128-key tiles, 191 and 193 its
   192-row q tiles, 1025 is BEiT-L-512's N with one key in its last tile):
   a padded stack layer with 1e6 in the pads, an unpadded (1, H, N, N),
   (B, H, N, N), (1, 1, 1, N) and (1, 1, N, 1), and a negative scale.
   Tolerance: atol = rtol = 2e-5 in float32, as in
   tests/test_torch_attention_bias.py: the two differ only in float32
   summation order and exp vs exp2.
2. The layout predicate ``bias_fill`` that picks the kernel's bias fill
   (a TMA tensor map, or plain loads by the producer's warps), for each
   bias source chip_smoke.py sends: padded stack layers and BEiT's inline
   layer take TMA, the rest the copy.
3. A stub of the kernel library reads the int64 argument array as the C
   entry does (``enum Slot`` of csrc/flash_attention.cu, with
   SLOT_BIAS_FILL), requires of a TMA fill what the tensor map requires,
   and runs the plain version into ``out``: biased slabs and (B, N, H, D)
   views arrive with the right strides, offset and fill, and reproduce the
   plain version exactly.
4. Every bias case of tests/test_torch_attention_bias.py still launches
   through the wrappers: none raises."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from muggled_dpt_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from muggled_dpt_tpu.ops.pallas.flash_attention import flash_attention_fused_qkv as jax_fused_qkv
from muggled_dpt_tpu_torch.models.beit import compute_bias_stack, padded_tokens
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)
D = 64
HEADS = 16  # BEiT-L: C = 1024
CU_SOURCE = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
CPU = torch.device("cpu")


def _rand(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _padded_stack(seed, layers, h, n, multiple=8):
    """A (L, H, Np, Np) stack, Np = N rounded up to ``multiple`` (8: the
    port's cached stack; 128: what the JAX kernel asks of a stack), 1e6 in
    every pad."""
    n_pad = (n + multiple - 1) // multiple * multiple
    stack = _rand(seed, layers, h, n_pad, n_pad)
    stack[..., n:, :] = 1e6
    stack[..., :, n:] = 1e6
    return stack


def _bias_source(source, seed, b, h, n):
    """(keyword arguments of the fused entry, dense bias of the (B, N, H, D) entry)."""
    if source == "stack":
        stack = _padded_stack(seed, 3, h, n, multiple=128)
        return {"bias_stack": stack, "layer": 2}, stack[2][None]
    shape = {"(1,H,N,N)": (1, h, n, n), "(B,H,N,N)": (b, h, n, n), "(1,1,1,N)": (1, 1, 1, n), "(1,1,N,1)": (1, 1, n, 1)}[source]
    bias = _rand(seed, *shape, scale=4.0 if 1 in shape[2:] else 1.0)
    return {"bias": bias}, bias


JAX_CASES = [  # (N, B, H, bias source, entry, scale)
    (127, 1, 2, "stack", "fused", None),
    (127, 2, 2, "(B,H,N,N)", "bnhd", None),
    (129, 2, 2, "(1,H,N,N)", "fused", None),
    (129, 1, 2, "(1,1,1,N)", "bnhd", None),
    (191, 1, 2, "(1,1,N,1)", "fused", None),
    (191, 1, 2, "stack", "bnhd", None),
    (193, 2, 2, "(B,H,N,N)", "fused", None),
    (193, 1, 2, "stack", "fused", -0.3),
    (257, 1, 2, "(1,H,N,N)", "bnhd", -0.3),
    (257, 2, 2, "stack", "fused", None),
    (1025, 1, 2, "stack", "fused", None),
    (1025, 1, 2, "(1,H,N,N)", "bnhd", None),
]


@pytest.mark.parametrize("n, b, h, source, entry, scale", JAX_CASES,
                         ids=[f"{c[4]}-N{c[0]}-B{c[1]}-{c[3]}{'-scale' + str(c[5]) if c[5] else ''}" for c in JAX_CASES])
def test_biased_plain_versions_match_jax_kernels_at_tile_edges(n, b, h, source, entry, scale):
    """#2 (fused entry) and #4 (the (B, N, H, D) entry, as the JAX BEiT route
    hands its padded layer over) through the CPU wrappers, which run the
    plain versions, against the JAX kernels in interpret mode."""
    seed = 10 * n + b
    kw, dense = _bias_source(source, seed + 1, b, h, n)
    if entry == "fused":
        qkv = _rand(seed, b, n, h * 3 * D)
        jkw = dict(kw, layer=np.int32(kw["layer"])) if "layer" in kw else kw
        want = np.asarray(jax_fused_qkv(qkv, h, scale=scale, interpret=True, **jkw))
        got = fa.flash_attention_fused_qkv(_t(qkv), h, scale=scale, **{k: _t(v) if isinstance(v, np.ndarray) else v
                                                                       for k, v in kw.items()}).numpy()
    else:
        q, k, v = (_rand(seed + 2 + i, b, n, h, D) for i in range(3))
        want = np.asarray(jax_flash(q, k, v, bias=dense, scale=scale, interpret=True))
        got = fa.flash_attention(_t(q), _t(k), _t(v), bias=_t(dense), scale=scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _chip_smoke_sources():
    """chip_smoke.py's bias sources at its shapes (bf16, on the CPU), with
    the fill each must take. Shapes and strides only: zeros are enough."""
    bf16 = dict(dtype=torch.bfloat16)
    n, n_pad = 1025, padded_tokens((32, 32))  # BEiT-L-512: 1032
    stack = torch.zeros(24, HEADS, n_pad, n_pad, **bf16)
    big_n = 4097
    big = torch.zeros(2, HEADS, padded_tokens((64, 64)), padded_tokens((64, 64)), **bf16)  # two layers of the 1024x1024 stack
    lut = torch.zeros(1, (2 * 32 - 1) ** 2 + 3, HEADS)
    inline = compute_bias_stack(lut[0:1], (32, 32), (32, 32), padded_tokens((32, 32)), torch.bfloat16)  # a block's own layer
    odd = torch.zeros(1, HEADS, 392, 392, **bf16)[:, :, 1:, 1:]
    return {
        # (fused-entry keyword arguments, B, N): fill
        "stack layer 0": (({"bias_stack": stack, "layer": 0}, 8, n), fa.BIAS_FILL_TMA),
        "stack layer 23": (({"bias_stack": stack, "layer": 23}, 8, n), fa.BIAS_FILL_TMA),
        "1024x1024 stack layer 1": (({"bias_stack": big, "layer": 1}, 1, big_n), fa.BIAS_FILL_TMA),
        "inline layer (1,H,Np,Np)": (({"bias": inline}, 8, n), fa.BIAS_FILL_TMA),
        "stack layer as (1,H,Np,Np)": (({"bias": stack[23][None]}, 8, n), fa.BIAS_FILL_TMA),
        "(B,H,Np,Np) N=385": (({"bias": torch.zeros(8, HEADS, 392, 392, **bf16)}, 8, 385), fa.BIAS_FILL_TMA),
        "(1,H,N,N) N=128": (({"bias": torch.zeros(1, HEADS, 128, 128, **bf16)}, 1, 128), fa.BIAS_FILL_TMA),
        "(1,H,N,N) unpadded": (({"bias": torch.zeros(1, HEADS, n, n, **bf16)}, 8, n), fa.BIAS_FILL_COPY),
        "(B,H,N,N) unpadded": (({"bias": torch.zeros(8, HEADS, n, n, **bf16)}, 8, n), fa.BIAS_FILL_COPY),
        "(1,1,1,N)": (({"bias": torch.zeros(1, 1, 1, n, **bf16)}, 8, n), fa.BIAS_FILL_COPY),
        "(1,1,N,1)": (({"bias": torch.zeros(1, 1, n, 1, **bf16)}, 8, n), fa.BIAS_FILL_COPY),
        "(1,H,Np,Np) view at an odd offset": (({"bias": odd}, 8, 385), fa.BIAS_FILL_COPY),
        "N=1 (1,H,1,1)": (({"bias": torch.zeros(1, HEADS, 1, 1, **bf16)}, 1, 1), fa.BIAS_FILL_COPY),
        "(1,H,N,N) float32": (({"bias": torch.zeros(1, HEADS, n, n)}, 8, n), fa.BIAS_FILL_COPY),
    }


@pytest.mark.parametrize("source", list(_chip_smoke_sources()))
def test_bias_fill_for_each_chip_smoke_source(source):
    (kw, b, n), want = _chip_smoke_sources()[source]
    operand = fa._bias_operand(kw.get("bias"), kw.get("bias_stack"), kw.get("layer"), b, HEADS, n, CPU)
    assert fa.bias_fill(operand) == want


def test_bias_fill_reads_alignment_from_the_address_and_every_stride():
    """Each TMA rule broken alone sends the bias to the copy."""
    n = 64
    ok = (1, (4096, 0, 0, n * n, n, 1))
    assert fa.bias_fill(ok) == fa.BIAS_FILL_TMA
    for i, value in ((0, 4098), (1, 1), (2, 8 * n * n + 4), (3, n * n + 2), (4, n + 1), (4, 0), (5, 2), (5, 0)):
        args = list(ok[1])
        args[i] = value
        assert fa.bias_fill((1, tuple(args))) == fa.BIAS_FILL_COPY, (i, value)
    assert fa.bias_fill((0, ok[1])) == fa.BIAS_FILL_COPY  # a float32 bias: not the bf16 kernel's


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
    the argument array as the C entry does, requires of a TMA bias fill what
    the bias's tensor map requires (bf16, unit column stride, rows not
    broadcast, 16-byte aligned first element and byte strides), views the
    memory at each address with its strides (size 1 where a bias stride is
    0) and runs the plain version into ``out``."""

    def __init__(self, slots):
        self.slots, self.calls, self.operands, self.bias, self.fill = slots, 0, {}, None, None

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
        views = []
        for name in ("Q", "K", "V", "O"):
            addr, *strides = a[s[f"SLOT_{name}"] : s[f"SLOT_{name}"] + 4]
            self.operands[name] = (addr, tuple(strides))
            views.append(self._view(addr, (b, n, h, d), [*strides, 1], dtype))
        q, k, v, o = views
        bias, code, self.fill = None, a[s["SLOT_BIAS_DTYPE"]], a[s["SLOT_BIAS_FILL"]]
        if code >= 0:
            addr, offset, *strides = a[s["SLOT_BIAS"] : s["SLOT_BIAS"] + 6]
            bias_dtype = [torch.float32, torch.bfloat16, torch.float16][code]
            es = torch.empty((), dtype=bias_dtype).element_size()
            self.bias = (addr, offset, tuple(strides))
            if dtype in fa.HALF_TYPES and bias_dtype == dtype and self.fill == fa.BIAS_FILL_TMA:
                sb, sh, sn, sk = strides
                assert sk == 1 and sn != 0 and (addr + offset * es) % 16 == 0, (addr, offset, strides)
                assert all(st * es % 16 == 0 for st in (sb, sh, sn)), strides
            sizes = [size if st else 1 for size, st in zip((b, h, n, n), strides)]
            bias = self._view(addr + offset * es, sizes, strides, bias_dtype)
        o.copy_(fa.flash_attention_reference(q, k, v, bias=bias, scale=scale_log2 / fa.LOG2E))
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


def test_fill_slot_is_appended_after_the_device():
    slots = _slots()
    assert slots["SLOT_BIAS_FILL"] == slots["SLOT_DEVICE"] + 1 == slots["NUM_SLOTS"] - 1


def _split(qkv, h):
    x = qkv.unflatten(2, (h, 3, D))
    return x[..., 0, :], x[..., 1, :], x[..., 2, :]


def _call(entry, qkv, h, kw):
    """(the entry's output, the plain version of what the stub receives:
    the (B, N, H, D) reference on the bf16 views and the dense bias)."""
    q, k, v = _split(qkv, h)
    scale = kw.get("scale")
    bias = fa._layer_bias(kw.get("bias"), kw.get("bias_stack"), kw.get("layer"))
    want = fa.flash_attention_reference(q, k, v, bias=bias, scale=scale)
    if entry == "fused":
        return fa.flash_attention_fused_qkv(qkv, h, **kw), want.flatten(2)
    return fa.flash_attention(q, k, v, **kw), want


STUB_SOURCES = ["stack layer", "inline (1,H,Np,Np)", "(1,H,N,N) unpadded", "(B,H,Np,Np)", "(1,1,1,N)", "(1,1,N,1)",
                "odd offset view", "float32 (1,H,N,N)"]


def _stub_bias(source, b, n, dtype):
    """(fused-entry keyword arguments, the bias operand's expected (offset,
    strides) relative to the tensor handed over, the expected fill)."""
    n_pad = (n + 7) // 8 * 8
    stack = _t(_padded_stack(3, 4, HEADS, n), dtype)
    if source == "stack layer":
        return {"bias_stack": stack, "layer": 3}, (3 * HEADS * n_pad**2, (0, n_pad**2, n_pad, 1)), fa.BIAS_FILL_TMA
    if source == "inline (1,H,Np,Np)":
        return {"bias": stack[1][None]}, (0, (0, n_pad**2, n_pad, 1)), fa.BIAS_FILL_TMA
    if source == "(1,H,N,N) unpadded":
        return {"bias": _t(_rand(4, 1, HEADS, n, n), dtype)}, (0, (0, n * n, n, 1)), fa.BIAS_FILL_COPY
    if source == "(B,H,Np,Np)":
        return {"bias": stack[:b]}, (0, (HEADS * n_pad**2, n_pad**2, n_pad, 1)), fa.BIAS_FILL_TMA
    if source == "(1,1,1,N)":
        return {"bias": _t(_rand(5, 1, 1, 1, n, scale=4.0), dtype)}, (0, (0, 0, 0, 1)), fa.BIAS_FILL_COPY
    if source == "(1,1,N,1)":
        return {"bias": _t(_rand(6, 1, 1, n, 1, scale=4.0), dtype)}, (0, (0, 0, 1, 0)), fa.BIAS_FILL_COPY
    if source == "odd offset view":
        return {"bias": stack[1:2, :, 1:, 1:]}, (0, (0, n_pad**2, n_pad, 1)), fa.BIAS_FILL_COPY
    return {"bias": _t(_rand(7, 1, HEADS, n, n))}, (0, (0, n * n, n, 1)), fa.BIAS_FILL_COPY


@pytest.mark.parametrize("source", STUB_SOURCES)
@pytest.mark.parametrize("entry", ["fused", "bnhd"])
def test_biased_launch_through_stub_library(stub, source, entry):
    """BEiT-L's widths (16 heads, 3C = 3072) at B=2, N=129 in bf16: q, k, v,
    out and the bias reach the C entry with their strides, the stack layer
    as an element offset, the fill from the layout, and the stub's plain
    version of what arrived equals the plain version of the call."""
    b, n = 2, 129
    qkv = _t(_rand(1, b, n, HEADS * 3 * D), torch.bfloat16)
    kw, (offset, strides), fill = _stub_bias(source, b, n, torch.bfloat16)
    if entry == "bnhd" and "bias_stack" in kw:
        kw = {"bias": kw["bias_stack"][kw["layer"]][None]}
        offset = 0
    fa.reset_launch_counts()
    got, want = _call(entry, qkv, HEADS, kw)
    assert fa.launch_counts()["fused_biased" if entry == "fused" else "bnhd"] == 1
    es, ptr, c3 = qkv.element_size(), qkv.data_ptr(), 3 * HEADS * D
    for i, name in enumerate(("Q", "K", "V")):
        assert stub.operands[name] == (ptr + i * D * es, (n * c3, c3, 3 * D))
    assert stub.calls == 1
    t = kw.get("bias", kw.get("bias_stack"))
    assert stub.bias == (t.data_ptr(), offset, strides)
    assert stub.fill == fill
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _parent_cases():
    """Every bias case tests/test_torch_attention_bias.py hands the
    wrappers, as (entry, b, n, h, keyword arguments) in bf16."""
    bf16 = torch.bfloat16
    cases = [("fused", 2, 200, 2, {"bias": _t(_rand(8, 2, 2, 200, 200), bf16)})]
    padded = np.pad(_rand(10, 1, 2, 200, 200), ((0, 0), (0, 0), (0, 56), (0, 56)), constant_values=1e6)
    cases += [(entry, 1, 200, 2, {"bias": _t(padded, bf16)}) for entry in ("fused", "bnhd")]
    stack = _t(_rand(13, 3, 2, 256, 256), bf16)
    cases += [("fused", 1, 200, 2, {"bias_stack": stack, "layer": layer}) for layer in range(3)]
    for shape in ((1, 1, 1, 200), (1, 2, 1, 200), (1, 1, 200, 1)):
        cases += [(entry, 1, 200, 2, {"bias": _t(_rand(4, *shape, scale=4.0), bf16)}) for entry in ("fused", "bnhd")]
    cases += [(entry, 1, 130, 2, {"bias": torch.full((1, 1, 130, 130), -40.0, dtype=bf16)}) for entry in ("fused", "bnhd")]
    cases += [("bnhd", 1, 2148, 1, {"bias": _t(_rand(23, 1, 2148, 2148), bf16)[:, None]})]
    cases += [(entry, 1, 100, 2, {"bias": _t(_rand(2, 1, 2, 100, 100), bf16), "scale": 0.3}) for entry in ("fused", "bnhd")]
    cases += [("bnhd", 2, 70, 2, {"bias": _t(_rand(7, 1, 2, 70, 70), bf16)})]
    cases += [("fused", 1, 60, 2, {"bias": _t(_rand(9, 1, 2, 60, 60), bf16)}),
              ("fused", 1, 60, 2, {"bias_stack": _t(_rand(10, 2, 2, 64, 64), bf16), "layer": 1})]
    cases += [("fused", 1, 40, 2, {"bias_stack": _t(np.pad(_rand(40, 3, 2, 40, 40), ((0, 0), (0, 0), (0, 8), (0, 8)),
                                                            constant_values=1e6), bf16), "layer": 1})]
    return cases


def test_every_bias_case_the_parent_took_still_launches(stub):
    """No new check refuses a bias the parent's wrapper took: each case of
    tests/test_torch_attention_bias.py, in bf16, launches (and matches the
    plain version) through the stub."""
    cases = _parent_cases()
    for i, (entry, b, n, h, kw) in enumerate(cases):
        got, want = _call(entry, _t(_rand(100 + i, b, n, h * 3 * D), torch.bfloat16), h, kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert stub.calls == len(cases)
