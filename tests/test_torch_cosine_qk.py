"""SwinV2's cosine normalization of q and k (``ops/kernels/cosine_qk.py``,
``csrc/cosine_qk.cu``) on the CPU: the wrapper's plain route against the
block's float32 composite, bit for bit, at every SwinV2-L-384 stage shape and
at the head counts tensor parallelism splits them into; the kernel route's
pointers, strides, sizes and dtype codes read back through a stub of the
kernel library that computes the composite on the memory it is handed; the
wrapper's refusals; the launch count; and the kernel's name against the
benchmark's name lists, so that it counts as the encoder's glue and not as
attention or a matrix product. The kernel itself runs only on the card
(``chip_smoke.py:phase_cosine_qk``)."""

import array
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import cosine_qk as cq
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from port_bench import spec

CU_SOURCE = Path(cq.__file__).resolve().parents[2] / "csrc" / "cosine_qk.cu"
DTYPE_CODES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
D = 32
# SwinV2-L-384's four stages at 384x384: (windows, window area, heads)
STAGES = [(16, 576, 6), (4, 576, 12), (1, 576, 24), (1, 144, 48)]
B = 2


def composite(q, k, logit_scale):
    """The SwinV2 block's float32 composite: l2-normalize q and k over the
    head dim, fold the logit scale into q, cast both to q's dtype."""
    qf, kf = q.float(), k.float()
    qf = qf * torch.rsqrt((qf * qf).sum(dim=-1, keepdim=True) + 1e-12)
    kf = kf * torch.rsqrt((kf * kf).sum(dim=-1, keepdim=True) + 1e-12)
    return (qf * logit_scale.float().reshape(q.shape[-2], 1)).to(q.dtype), kf.to(q.dtype)


def qkv_views(b, nw, a, h, dtype, seed=0, d=D):
    """q, k of a (B, nW, A, 3, H, D) qkv output, as the block unbinds it, and an (H,) logit scale."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, nw, a, 3, h, d, generator=g).to(dtype)
    q, k, _ = qkv.unbind(3)
    scale = (torch.rand(h, generator=g) * 90 + 10).to(dtype)  # exp(min(ls, log 100)): between 1 and 100
    return q, k, scale


def _slots() -> dict:
    """``enum Slot`` of csrc/cosine_qk.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", CU_SOURCE.read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


def _view(addr, sizes, strides, dtype):
    extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
    buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)


class StubLibrary:
    """Stands in for the kernel library: reads the int64 argument array as
    the C entry does, views q and k at their addresses through the strides
    it was given, the scale in their dtype and the outputs as
    dense (B, nW, A, H, 32) tensors, and writes the composite into them."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    def mdpt_cosine_qk(self, args_ptr, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        sizes = tuple(a[s[k]] for k in ("SLOT_BATCH", "SLOT_WINDOWS", "SLOT_AREA", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype = DTYPE_CODES[a[s["SLOT_DTYPE"]]]
        strides = {t: tuple(a[s[f"SLOT_{t}_STRIDE_{d}"]] for d in "BWAH") + (1,) for t in ("Q", "K")}
        q, k = (_view(a[s[f"SLOT_{t}"]], sizes, strides[t], dtype) for t in ("Q", "K"))
        scale = _view(a[s["SLOT_SCALE"]], (sizes[3],), (1,), dtype)
        qs, kn = (_view(a[s[f"SLOT_{t}"]], sizes, torch.empty(sizes, device="meta").stride(), dtype) for t in ("QS", "KN"))
        want_q, want_k = composite(q, k, scale)
        qs.copy_(want_q)
        kn.copy_(want_k)
        self.calls.append({"sizes": sizes, "dtype": dtype, "strides": strides,
                           "device": a[s["SLOT_DEVICE"]], "pointers": {t: a[s[f"SLOT_{t}"]] for t in
                                                                       ("Q", "K", "SCALE", "QS", "KN")}})
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        return array.array(code, [0 if x is None else x for x in values])

    monkeypatch.setattr(cq, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(cq, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa.reset_launch_counts()
    return lib


CPU_CASES = [(f"stage{i + 1}", nw, a, h, dtype) for i, (nw, a, h) in enumerate(STAGES)
             for dtype in (torch.bfloat16, torch.float16, torch.float32)]
CPU_CASES += [(f"stage{i + 1}_split{parts}", nw, a, h // parts, torch.bfloat16) for i, (nw, a, h) in enumerate(STAGES)
              for parts in (2, 3) if h % parts == 0]


@pytest.mark.parametrize("name,nw,a,h,dtype", CPU_CASES, ids=[c[0] + "-" + str(c[4])[6:] for c in CPU_CASES])
def test_cpu_route_is_the_composite_bit_for_bit(name, nw, a, h, dtype):
    """The plain route at SwinV2-L-384's stage shapes (B=2) and at split
    head counts (tensor parallelism's per-rank heads): equal to the block's
    composite bit for bit, new contiguous tensors, and no launch."""
    fa.reset_launch_counts()
    q, k, scale = qkv_views(B, nw, a, h, dtype, seed=h)
    qs, kn = cq.cosine_qk(q, k, scale)
    want_q, want_k = composite(q, k, scale)
    for got, want in ((qs, want_q), (kn, want_k)):
        assert got.shape == (B, nw, a, h, D) and got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(n == 0 for n in fa.launch_counts().values())


def test_cpu_route_takes_any_head_width():
    """Only the kernel is built for 32-wide heads: the plain route serves
    the toy models' narrower ones."""
    q, k, scale = qkv_views(1, 2, 16, 2, torch.float32, d=8)
    for got, want in zip(cq.cosine_qk(q, k, scale), composite(q, k, scale)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


STUB_CASES = [
    ("qkv_views_bf16", torch.bfloat16, False),
    ("qkv_views_f16", torch.float16, False),
    ("qkv_views_f32", torch.float32, False),
    ("k_apart_bf16", torch.bfloat16, True),  # k a tensor of its own, with its own strides
    ("k_apart_f16", torch.float16, True),
]


@pytest.mark.parametrize("name,dtype,k_apart", STUB_CASES, ids=[c[0] for c in STUB_CASES])
@pytest.mark.parametrize("stage", range(len(STAGES)), ids=[f"stage{i + 1}" for i in range(len(STAGES))])
def test_wrapper_arguments_through_stub_library(stub, name, dtype, k_apart, stage):
    """The kernel route's addresses, strides, sizes and dtype codes, read
    back by a stub that computes the composite on the memory it was handed:
    the outputs equal the composite on the original views, counted once."""
    nw, a, h = STAGES[stage]
    nw = min(nw, 4)  # the stub computes on the CPU: fewer windows keep it fast
    q, k, scale = qkv_views(1, nw, a, h, dtype, seed=stage)
    if k_apart:
        k = torch.randn(1, nw, h, a, D, generator=torch.Generator().manual_seed(9)).to(dtype).transpose(2, 3)
    qs, kn = cq.cosine_qk(q, k, scale)
    (call,) = stub.calls
    assert call["sizes"] == (1, nw, a, h, D) and call["dtype"] == dtype
    assert call["strides"] == {"Q": q.stride(), "K": k.stride()} and call["device"] == 0
    assert call["pointers"] == {"Q": q.data_ptr(), "K": k.data_ptr(), "SCALE": scale.data_ptr(), "QS": qs.data_ptr(),
                                "KN": kn.data_ptr()}
    want_q, want_k = composite(q, k, scale)
    for got, want in ((qs, want_q), (kn, want_k)):
        assert got.is_contiguous() and got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fa.launch_counts()["cosine_qk"] == 1 and sum(fa.launch_counts().values()) == 1


@pytest.mark.parametrize("make,match", [
    (lambda: qkv_views(1, 2, 16, 2, torch.bfloat16, d=16), "head_dim 32 only"),
    (lambda: qkv_views(1, 2, 16, 2, torch.bfloat16, d=64), "head_dim 32 only"),
    (lambda: (lambda q, k, s: (q, k.float(), s))(*qkv_views(1, 2, 16, 2, torch.bfloat16)), "want torch.bfloat16"),
    (lambda: (lambda q, k, s: (q, k, s.half()))(*qkv_views(1, 2, 16, 2, torch.bfloat16)), "logit_scale"),
    (lambda: (lambda q, k, s: (q, k, s.float()))(*qkv_views(1, 2, 16, 2, torch.bfloat16)), "logit_scale"),
    (lambda: (lambda q, k, s: (q, k, s.repeat(2)[::2]))(*qkv_views(1, 2, 16, 2, torch.bfloat16)), "contiguous"),
    (lambda: (lambda q, k, s: (q, k, s[:1]))(*qkv_views(1, 2, 16, 2, torch.bfloat16)), r"must be \(H,\)"),
    (lambda: (lambda q, k, s: (q, k[:, :1], s))(*qkv_views(1, 2, 16, 2, torch.bfloat16)), "share one"),
    (lambda: (lambda q, k, s: (q.double(), k.double(), s))(*qkv_views(1, 2, 16, 2, torch.float32)),
             "takes float32"),
    # rows 2 bytes off 16: a (B, nW, A, H, 33) buffer read from its second element
    (lambda: (lambda t: (t[..., 1:], t[..., :32], torch.ones(2, dtype=torch.bfloat16)))(
        torch.randn(1, 2, 16, 2, 33).to(torch.bfloat16)), "16-byte aligned"),
    # a head stride of 36 elements: 72 bytes, no multiple of 16
    (lambda: (lambda t: (t[..., :32], t[..., :32], torch.ones(2, dtype=torch.bfloat16)))(
        torch.randn(1, 2, 16, 2, 36).to(torch.bfloat16)), "16-byte aligned"),
    (lambda: (lambda q, k, s: (q, k.transpose(3, 4), s))(*qkv_views(1, 2, 32, 32, torch.bfloat16)),
             "contiguous head dim"),
], ids=["d16", "d64", "k_dtype", "scale_dtype", "scale_f32", "scale_strided", "scale_shape", "k_shape", "float64",
        "misaligned_base", "misaligned_stride", "strided_head_dim"])
def test_kernel_route_refuses_what_the_kernel_does_not_read(stub, make, match):
    q, k, scale = make()
    with pytest.raises(ValueError, match=match):
        cq.cosine_qk(q, k, scale)
    assert not stub.calls and fa.launch_counts()["cosine_qk"] == 0


def test_grad_requiring_operand_raises(stub):
    q, k, scale = qkv_views(1, 2, 16, 2, torch.float32)
    scale.requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        cq.cosine_qk(q, k, scale)
    with torch.no_grad():
        assert not any(t.requires_grad for t in cq.cosine_qk(q, k, scale))
    assert len(stub.calls) == 1


def test_a_refused_launch_raises(stub, monkeypatch):
    monkeypatch.setattr(stub, "mdpt_cosine_qk", lambda *args: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        cq.cosine_qk(*qkv_views(1, 2, 16, 2, torch.bfloat16))
    assert all(n == 0 for n in fa.launch_counts().values())


def test_launch_counts_list_the_route():
    fa.reset_launch_counts()
    assert fa.launch_counts()["cosine_qk"] == 0 and "cosine_qk" in _build.ROUTES


def _kernel_names() -> list:
    """The demangled names a device trace shows for each instance of the
    source's ``__global__`` functions: its template arguments and parameter
    types included, as the benchmark's trace reads them."""
    src = CU_SOURCE.read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(const (\w+)", src)
    instances = re.findall(r"(\w+)<(\w+)><<<", src)
    assert kernels and len(instances) == 1
    types_of = {"float": "float", "bf16": "__nv_bfloat16", "__half": "__half"}
    return [f"void (anonymous namespace)::{name}<{types_of[t]}>((anonymous namespace)::{arg})"
            for name, arg in kernels for t in re.findall(r"launch<(\w+)>\(a, s\)", src)]


def test_kernel_name_counts_as_encoder_glue():
    """No substring of ``attention.roofline_pct``'s ``PATTERNS`` or of
    ``encoder.glue_device_ms``'s ``PRODUCTS`` lies in any instance's name:
    the benchmark counts the pass in the encoder's glue, and #3's roofline
    share reads the same kernels as before."""
    patterns = spec.metric_reader("attention.roofline_pct").PATTERNS
    products = spec.metric_reader("encoder.glue_device_ms").PRODUCTS
    names = _kernel_names()
    assert len(names) == 3 and any("cosine_qk_sm90<__nv_bfloat16>" in n for n in names)
    assert not [(n, p) for n in names for p in patterns + products if p in n]
