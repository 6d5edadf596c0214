"""ViT-Giant's SwiGLU gate (``ops/kernels/swiglu_gate.py``,
``csrc/swiglu_gate.cu``) on the CPU: the wrapper's plain route against the
composite ``F.silu(a) * b``, bit for bit, at ViT-Giant's width (H 4096), two
ranks' (2048) and a width no 16-byte vector divides, in three dtypes; the
kernel route's pointers, sizes, instance and dtype code read back through a
stub of the kernel library that holds the C entry's refusals and computes
the composite on the memory it is handed; the wrapper's refusals; one
launch inside each ``gate`` span through a whole ViT-Giant forward; the
plain composite under ``plain_attention``, where gradients flow; and the
kernel's name against the benchmark's name lists, so that it counts as the
encoder's glue. The kernel itself runs only on the card
(``chip_smoke.py:phase_swiglu_gate``)."""

import array
import ctypes
import re
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from muggled_dpt_tpu_torch import make_depthanythingv2_dpt
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import swiglu_gate as sg
from muggled_dpt_tpu_torch.parallel.train import adamw, make_train_step, plain_attention
from muggled_dpt_tpu_torch.utils.observability import tracing
from port_bench import spec

CU_SOURCE = Path(sg.__file__).resolve().parents[2] / "csrc" / "swiglu_gate.cu"
DTYPE_CODES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# ViT-Giant's hidden width, its half on each of two ranks, and an even width that no 16-byte vector divides
WIDTHS = {"giant": 4096, "two_ranks": 2048, "ragged": 1366}
LEADING = {"2d": (37,), "3d": (2, 19)}  # rows as (B*N,) and as (B, N)


def composite(x12):
    """The SwiGLU block's gate as ``ops/nn.py:mlp_swiglu`` ran it before the kernel."""
    h = x12.shape[-1] // 2
    return F.silu(x12[..., :h]) * x12[..., h:]


def operand(leading, hidden, dtype, seed=0):
    """w12's output: a spread of values that crosses silu's bend, in dtype."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*leading, 2 * hidden, generator=g) * 4).to(dtype)


def _slots() -> dict:
    """``enum Slot`` of csrc/swiglu_gate.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", CU_SOURCE.read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


def _view(addr, sizes, dtype):
    """A dense tensor of ``sizes`` at ``addr``."""
    n = int(np.prod(sizes))
    buf = (ctypes.c_byte * (n * torch.empty((), dtype=dtype).element_size())).from_address(addr)
    return torch.frombuffer(buf, dtype=dtype).reshape(sizes)


class StubLibrary:
    """Stands in for the kernel library: reads the int64 argument array as
    the C entry does, refuses what it refuses (rows aside, the vector
    instance needs a row of h a whole number of 16-byte vectors and both
    pointers 16-byte aligned), views x12 and the output at their addresses
    as dense tensors, writes the composite into the output and records the
    call and the host clock's time of it."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    def mdpt_swiglu_gate(self, args_ptr, stream):
        s = self.slots
        a = {k: v for k, v in zip(sorted(s, key=s.get), (ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))}
        rows, hidden, vector = a["SLOT_ROWS"], a["SLOT_HIDDEN"], a["SLOT_VECTOR"]
        dtype = DTYPE_CODES[a["SLOT_DTYPE"]]
        elem = torch.empty((), dtype=dtype).element_size()
        if rows and vector and (hidden * elem % 16 or a["SLOT_X12"] % 16 or a["SLOT_OUT"] % 16):
            return 1  # cudaErrorInvalidValue
        if rows:
            x12 = _view(a["SLOT_X12"], (rows, 2 * hidden), dtype)
            _view(a["SLOT_OUT"], (rows, hidden), dtype).copy_(composite(x12))
        self.calls.append({"rows": rows, "hidden": hidden, "vector": vector, "dtype": dtype,
                           "device": a["SLOT_DEVICE"], "x12": a["SLOT_X12"], "out": a["SLOT_OUT"],
                           "t_ns": time.perf_counter_ns()})
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        return array.array(code, [0 if x is None else x for x in values])

    monkeypatch.setattr(sg, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(sg, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa.reset_launch_counts()
    return lib


CASES = [(w, lead, dtype) for w in WIDTHS for lead in LEADING for dtype in DTYPES]
IDS = [f"{w}-{lead}-{str(dtype)[6:]}" for w, lead, dtype in CASES]


@pytest.mark.parametrize("width,leading,dtype", CASES, ids=IDS)
def test_cpu_route_is_the_composite_bit_for_bit(width, leading, dtype):
    """The plain route: equal to ``F.silu(a) * b`` bit for bit, a new
    contiguous (..., H) tensor in x12's dtype, and no launch."""
    fa.reset_launch_counts()
    x12 = operand(LEADING[leading], WIDTHS[width], dtype, seed=WIDTHS[width])
    got = sg.swiglu_gate(x12)
    assert got.shape == (*LEADING[leading], WIDTHS[width]) and got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got, composite(x12), rtol=0, atol=0)
    assert all(n == 0 for n in fa.launch_counts().values())


@pytest.mark.parametrize("width,leading,dtype", CASES, ids=IDS)
def test_wrapper_arguments_through_stub_library(stub, width, leading, dtype):
    """The kernel route's addresses, rows, width, instance and dtype code,
    read back by a stub that computes the composite on the memory it was
    handed: the output equals the composite, counted once. The vector
    instance where a row of h is a whole number of 16-byte vectors."""
    hidden = WIDTHS[width]
    x12 = operand(LEADING[leading], hidden, dtype, seed=1)
    got = sg.swiglu_gate(x12)
    (call,) = stub.calls
    assert call["rows"] == int(np.prod(LEADING[leading])) and call["hidden"] == hidden
    assert call["dtype"] == dtype and call["device"] == 0
    assert call["vector"] == int(hidden * x12.element_size() % 16 == 0) == int(width != "ragged")
    assert call["x12"] == x12.data_ptr() and call["out"] == got.data_ptr()
    assert got.shape == (*LEADING[leading], hidden) and got.is_contiguous() and got.dtype == dtype
    torch.testing.assert_close(got, composite(x12), rtol=0, atol=0)
    assert fa.launch_counts()["swiglu_gate"] == 1 and sum(fa.launch_counts().values()) == 1


def _misaligned(t):
    """A contiguous copy of t that starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_misaligned_operand_takes_the_general_instance(stub, dtype):
    """x12 one element past a 16-byte boundary at ViT-Giant's width: the
    general instance, which the C entry takes at any alignment."""
    x12 = _misaligned(operand((5,), 4096, dtype))
    assert x12.data_ptr() % 16
    got = sg.swiglu_gate(x12)
    (call,) = stub.calls
    assert call["vector"] == 0 and call["x12"] == x12.data_ptr()
    torch.testing.assert_close(got, composite(x12), rtol=0, atol=0)


def test_the_stub_holds_the_c_entrys_refusals(stub, monkeypatch):
    """The stub's refusal is the C entry's, pinned to its text: the vector
    instance asked for on a misaligned operand fails the launch, and the
    wrapper raises."""
    source = CU_SOURCE.read_text()
    assert "if (rows == 0) return (int)cudaSuccess;" in source
    assert "(vector && (hidden * elem % 16 != 0 || x12 % 16 != 0 || out % 16 != 0 ||" in source
    monkeypatch.setattr(sg, "vector_instance", lambda x12: True)
    with pytest.raises(RuntimeError, match="launch failed"):
        sg.swiglu_gate(_misaligned(operand((5,), 4096, torch.bfloat16)))
    with pytest.raises(RuntimeError, match="launch failed"):
        sg.swiglu_gate(operand((5,), 1366, torch.bfloat16))
    assert not stub.calls and fa.launch_counts()["swiglu_gate"] == 0


def test_no_rows(stub):
    got = sg.swiglu_gate(torch.empty(0, 64, dtype=torch.bfloat16))
    assert got.shape == (0, 32) and stub.calls[0]["rows"] == 0


@pytest.mark.parametrize("shape", [(4, 7), (4, 0), (), (3, 1)], ids=["odd", "empty_row", "scalar", "one"])
def test_an_odd_or_empty_last_dim_is_refused_on_both_routes(stub, monkeypatch, shape):
    for route in (False, True):
        monkeypatch.setattr(sg, "_device_route", lambda device, name, route=route: route)
        with pytest.raises(ValueError, match="last dim must be 2H"):
            sg.swiglu_gate(torch.zeros(shape, dtype=torch.bfloat16))
    assert not stub.calls and fa.launch_counts()["swiglu_gate"] == 0


@pytest.mark.parametrize("make,match", [
    (lambda: operand((4,), 8, torch.float64), "takes float32, bfloat16 or float16"),
    (lambda: operand((4,), 8, torch.int32), "takes float32, bfloat16 or float16"),
    (lambda: operand((8,), 8, torch.bfloat16)[::2], "must be contiguous"),
    (lambda: operand((16,), 8, torch.bfloat16).t().contiguous().t(), "must be contiguous"),
], ids=["float64", "int32", "strided_rows", "transposed"])
def test_kernel_route_refuses_what_the_kernel_does_not_read(stub, make, match):
    with pytest.raises(ValueError, match=match):
        sg.swiglu_gate(make())
    assert not stub.calls and fa.launch_counts()["swiglu_gate"] == 0


def test_an_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device meta"):
        sg.swiglu_gate(torch.zeros(4, 16, device="meta"))


def test_grad_requiring_operand_raises(stub):
    x12 = operand((4,), 16, torch.float32).requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        sg.swiglu_gate(x12)
    with torch.no_grad():
        assert not sg.swiglu_gate(x12).requires_grad
    assert len(stub.calls) == 1


def test_a_refused_launch_raises(stub, monkeypatch):
    monkeypatch.setattr(stub, "mdpt_swiglu_gate", lambda *args: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        sg.swiglu_gate(operand((4,), 16, torch.bfloat16))
    assert all(n == 0 for n in fa.launch_counts().values())


def test_launch_counts_list_the_route():
    fa.reset_launch_counts()
    assert fa.launch_counts()["swiglu_gate"] == 0 and _build.ROUTES[-1] == "swiglu_gate"


SIZE = (112, 112)
BLOCKS = 4
FRAMES = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 60, 80, 3), np.uint8))


def make(is_giant=True, dtype=torch.float32):
    return make_depthanythingv2_dpt(64, 2, BLOCKS, (8, 16, 32, 64), (8, 8), 16, is_giant=is_giant, dtype=dtype,
                                    device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_giant_forward_launches_once_inside_each_gate_span(stub, monkeypatch, dtype):
    """A tiny ViT-Giant through the stub: one launch a block, each inside
    its block's ``gate`` span, at the Giant's (B*N, 2H) rows; the depth of
    the plain route's forward bit for bit."""
    model = make(dtype=dtype)
    with tracing() as spans:
        got = model.inference_rgb_device(FRAMES, SIZE)
    gates = [s for s in spans if s.name == "gate"]
    assert fa.launch_counts()["swiglu_gate"] == len(gates) == len(stub.calls) == BLOCKS
    for gate, call in zip(gates, stub.calls):
        assert gate.t0_ns <= call["t_ns"] <= gate.t1_ns
    hidden = model.net.encoder.blocks[0].mlp.w3.in_features
    assert {(c["rows"], c["hidden"], c["dtype"]) for c in stub.calls} == {(2 * (1 + 8 * 8), hidden, dtype)}
    monkeypatch.setattr(sg, "_device_route", lambda device, name: True)
    torch.testing.assert_close(got, model.inference_rgb_device(FRAMES, SIZE), rtol=0, atol=0)
    assert fa.launch_counts()["swiglu_gate"] == BLOCKS


def test_a_gelu_model_launches_none(stub):
    make(is_giant=False).inference_rgb_device(FRAMES, SIZE)
    assert not stub.calls and fa.launch_counts()["swiglu_gate"] == 0


def test_the_blocks_setting_reaches_the_gate():
    on = make_depthanythingv2_dpt(64, 2, 2, (8, 16, 32, 64), (8, 8), 16, is_giant=True, device="cpu")
    off = make_depthanythingv2_dpt(64, 2, 2, (8, 16, 32, 64), (8, 8), 16, is_giant=True, enable_optimizations=False,
                                   device="cpu")
    assert all(b.mlp.use_kernel for b in on.net.encoder.blocks)
    assert not any(b.mlp.use_kernel for b in off.net.encoder.blocks)


def test_plain_attention_trains_on_the_composite(stub):
    """A train step on the kernel route's model: ``plain_attention`` turns the
    gate's kernel off (no launch, and the grad guard never fires), gradients
    reach w12, and the kernel is back on after the step."""
    model = make()
    mlps = [b.mlp for b in model.net.encoder.blocks]
    step = make_train_step(model, adamw(model.net.parameters(), 1e-4))
    images = torch.randn(2, 56, 56, 3, generator=torch.Generator().manual_seed(3))
    before = mlps[0].w12.weight.detach().clone()
    loss = step(images, torch.rand(2, 56, 56, generator=torch.Generator().manual_seed(4)))
    assert np.isfinite(float(loss))
    assert not stub.calls and fa.launch_counts()["swiglu_gate"] == 0
    assert all(m.w12.weight.grad is not None and bool(m.w12.weight.grad.abs().sum() > 0) for m in mlps)
    assert not torch.equal(mlps[0].w12.weight.detach(), before)
    assert all(m.use_kernel for m in mlps)
    with plain_attention(model.net):
        assert not any(m.use_kernel for m in mlps)


def test_the_kernel_route_under_autograd_raises(stub):
    """Outside ``plain_attention`` a forward that records gradients meets the
    kernel's grad guard, not a silent launch."""
    model = make()
    with pytest.raises(RuntimeError, match="swiglu_gate: an operand requires grad"):
        model.net(torch.randn(1, 3, 56, 56))
    assert not stub.calls


def _kernel_names() -> list:
    """The demangled names a device trace shows for each instance of the
    source's ``__global__`` functions, as the benchmark's trace reads them."""
    src = CU_SOURCE.read_text()
    found = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(const (\w+)", src)
    assert [name for name, _ in found] == ["swiglu_gate_sm90", "swiglu_gate_any"]
    return [f"void (anonymous namespace)::{name}<{t}>((anonymous namespace)::{arg})"
            for name, arg in found for t in ("float", "__nv_bfloat16", "__half")]


def test_kernel_name_counts_as_encoder_glue():
    """No substring of ``attention.roofline_pct``'s ``PATTERNS`` or of
    ``encoder.glue_device_ms``'s ``PRODUCTS`` lies in any instance's name:
    the benchmark counts the pass in the encoder's glue, where torch's silu
    and product kernels were counted."""
    patterns = spec.metric_reader("attention.roofline_pct").PATTERNS
    products = spec.metric_reader("encoder.glue_device_ms").PRODUCTS
    names = _kernel_names()
    assert len(names) == 6 and any("swiglu_gate_sm90<__nv_bfloat16>" in n for n in names)
    assert not [(n, p) for n in names for p in patterns + products if p in n]
