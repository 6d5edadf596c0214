"""SwinV2's post-norm residual (``ops/kernels/postnorm_residual.py``,
``csrc/postnorm_residual.cu``) on the CPU: the wrapper's plain route against
the block's composite (``merge_windows``, ``torch.roll``, ``layer_norm``,
the add), bit for bit, at SwinV2-L-384's four stage shapes, shifted,
unshifted and in token order; the kernel route's pointers, sizes, window,
shift and dtype codes read back through a stub of the kernel library that
computes the composite on the memory it is handed; the wrapper's refusals;
the launch count, two a block through a whole SwinV2 forward; and the
kernel's name against the benchmark's name lists, so that it counts as the
encoder's glue and not as attention or a matrix product. The kernel itself
runs only on the card (``chip_smoke.py:phase_postnorm_residual``)."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import make_swinv2_dpt
from muggled_dpt_tpu_torch.models import swinv2
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import postnorm_residual as pr
from port_bench import spec

CU_SOURCE = Path(pr.__file__).resolve().parents[2] / "csrc" / "postnorm_residual.cu"
DTYPE_CODES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
# SwinV2-L-384's four stages at 384x384: (grid side, channels, window side, shift of the odd blocks)
STAGES = [(96, 192, 24, 12), (48, 384, 24, 12), (24, 768, 24, 0), (12, 1536, 12, 0)]
B = 1


def composite(x, h, weight, bias, window_hw=None, shift_hw=(0, 0)):
    """The SwinV2 block's composite on its own functions: merge proj's
    windows, roll them back, then ``x + layer_norm``."""
    if window_hw is not None:
        h = swinv2.merge_windows(h, window_hw, (x.shape[1], x.shape[2]))
        if shift_hw != (0, 0):
            h = torch.roll(h, shifts=shift_hw, dims=(1, 2))
    return x + swinv2.layer_norm(h, weight, bias, eps=swinv2.SWIN_LN_EPS)


def operands(b, side, c, window, dtype, seed=0):
    """x, h, weight, bias of one post-norm: h in window order for a window
    side, in token order for None."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, side, side, c, generator=g).to(dtype)
    shape = (b, (side // window) ** 2, window * window, c) if window else (b, side, side, c)
    h = (torch.randn(shape, generator=g) * 3 + 0.5).to(dtype)
    weight = (torch.rand(c, generator=g) + 0.5).to(dtype)
    bias = (torch.randn(c, generator=g) * 0.1).to(dtype)
    return x, h, weight, bias


def _slots() -> dict:
    """``enum Slot`` of csrc/postnorm_residual.cu: name -> index."""
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
    the C entry does, views x, h (in window order), the weight, the bias and
    the output at their addresses as dense tensors, and writes the
    composite into the output."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    def mdpt_postnorm_residual(self, args_ptr, stream):
        s = self.slots
        a = {k: v for k, v in zip(sorted(s, key=s.get), (ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))}
        b, gh, gw, c = (a[f"SLOT_{k}"] for k in ("BATCH", "GRID_H", "GRID_W", "CHANNELS"))
        window, shift = (a["SLOT_WINDOW_H"], a["SLOT_WINDOW_W"]), (a["SLOT_SHIFT_H"], a["SLOT_SHIFT_W"])
        dtype = DTYPE_CODES[a["SLOT_DTYPE"]]
        x, out = (_view(a[k], (b, gh, gw, c), dtype) for k in ("SLOT_X", "SLOT_OUT"))
        h = _view(a["SLOT_H"], (b, (gh // window[0]) * (gw // window[1]), window[0] * window[1], c), dtype)
        weight, bias = (_view(a[k], (c,), dtype) for k in ("SLOT_WEIGHT", "SLOT_BIAS"))
        out.copy_(composite(x, h, weight, bias, window, shift))
        self.calls.append({"sizes": (b, gh, gw, c), "window": window, "shift": shift, "dtype": dtype,
                           "device": a["SLOT_DEVICE"],
                           "pointers": {k: a[f"SLOT_{k}"] for k in ("X", "H", "WEIGHT", "BIAS", "OUT")}})
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        return array.array(code, [0 if x is None else x for x in values])

    monkeypatch.setattr(pr, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(pr, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa.reset_launch_counts()
    return lib


def _maps(side, window, shift):
    """The maps a stage's blocks run: unshifted windows, shifted ones where
    the stage shifts, and the token-order map of the MLP half."""
    out = [("windows", window, 0)] + ([("shifted", window, shift)] if shift else [])
    return out + [("token_order", None, 0)]


CPU_CASES = [(f"stage{i + 1}_{name}", side, c, win, sh, dtype) for i, (side, c, window, shift) in enumerate(STAGES)
             for name, win, sh in _maps(side, window, shift) for dtype in (torch.bfloat16, torch.float16, torch.float32)]


@pytest.mark.parametrize("name,side,c,window,shift,dtype", CPU_CASES,
                         ids=[f"{c[0]}-{str(c[5])[6:]}" for c in CPU_CASES])
def test_cpu_route_is_the_composite_bit_for_bit(name, side, c, window, shift, dtype):
    """The plain route at SwinV2-L-384's stage shapes (B=1): equal to the
    block's composite bit for bit, a new contiguous tensor, and no launch."""
    fa.reset_launch_counts()
    x, h, weight, bias = operands(B, side, c, window, dtype, seed=c + shift)
    window_hw = (window, window) if window else None
    got = pr.postnorm_residual(x, h, weight, bias, window_hw, (shift, shift))
    assert got.shape == x.shape and got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got, composite(x, h, weight, bias, window_hw, (shift, shift)), rtol=0, atol=0)
    assert all(n == 0 for n in fa.launch_counts().values())


def test_the_eps_is_swinv2s():
    assert pr.EPS == swinv2.SWIN_LN_EPS
    assert re.search(r"constexpr float EPS = 1e-5f;", CU_SOURCE.read_text())


def _source_rows(b, gh, gw, window_hw, shift_hw):
    """The kernel's gather on the host: for each output row (b, i, j) in
    order, the row of window-order h it reads, with the integer arithmetic
    of ``postnorm_residual_sm90``."""
    (wh, ww), (sh, sw) = window_hw, shift_hw
    rows = torch.arange(b * gh * gw)
    j, i, bb = rows % gw, (rows // gw) % gh, rows // (gw * gh)
    si = torch.where(i >= sh, i - sh, i + gh - sh)
    sj = torch.where(j >= sw, j - sw, j + gw - sw)
    w = (si // wh) * (gw // ww) + sj // ww
    return (bb * ((gh // wh) * (gw // ww)) + w) * (wh * ww) + (si % wh) * ww + sj % ww


@pytest.mark.parametrize("grid,window,shift", [((96, 96), (24, 24), (12, 12)), ((48, 48), (24, 24), (0, 0)),
                                               ((24, 24), (24, 24), (0, 0)), ((12, 18), (6, 9), (3, 4)),
                                               ((8, 8), (8, 8), (0, 0))])
def test_the_kernels_gather_inverts_the_blocks_roll_and_partition(grid, window, shift):
    """Row numbers of a (2, H, W) grid rolled and partitioned as the block
    does before qkv: the kernel's index arithmetic reads each output row
    from the window row that holds it, and the plain route's merge and roll
    bring the same rows home."""
    gh, gw = grid
    tokens = torch.arange(2 * gh * gw).reshape(2, gh, gw, 1)
    h = swinv2.partition_windows(torch.roll(tokens, shifts=(-shift[0], -shift[1]), dims=(1, 2)), window)
    assert torch.equal(h.reshape(-1)[_source_rows(2, gh, gw, window, shift)], tokens.reshape(-1))
    back = torch.roll(swinv2.merge_windows(h, window, grid), shifts=shift, dims=(1, 2))
    assert torch.equal(back, tokens)
    source = CU_SOURCE.read_text()
    for line in ("i >= a.shift_h ? i - a.shift_h : i + a.grid_h - a.shift_h",
                 "(si / a.win_h) * a.windows_w + sj / a.win_w",
                 "(b * a.windows + w) * a.area + (si % a.win_h) * a.win_w + sj % a.win_w"):
        assert line in source


STUB_CASES = [(f"stage{i + 1}_{name}_{str(dtype)[6:]}", i, win, sh, dtype) for i, (side, c, window, shift)
              in enumerate(STAGES) for name, win, sh in _maps(side, window, shift)
              for dtype in (torch.bfloat16, torch.float16, torch.float32)]


@pytest.mark.parametrize("name,stage,window,shift,dtype", STUB_CASES, ids=[c[0] for c in STUB_CASES])
def test_wrapper_arguments_through_stub_library(stub, name, stage, window, shift, dtype):
    """The kernel route's addresses, sizes, window, shift and dtype code,
    read back by a stub that computes the composite on the memory it was
    handed: the output equals the composite, counted once. With no window
    the kernel is told the grid is one window, unshifted."""
    side, c = STAGES[stage][:2]
    x, h, weight, bias = operands(B, side, c, window, dtype, seed=stage)
    window_hw = (window, window) if window else None
    got = pr.postnorm_residual(x, h, weight, bias, window_hw, (shift, shift))
    (call,) = stub.calls
    assert call["sizes"] == (B, side, side, c) and call["dtype"] == dtype and call["device"] == 0
    assert call["window"] == (window_hw or (side, side)) and call["shift"] == (shift, shift)
    assert call["pointers"] == {"X": x.data_ptr(), "H": h.data_ptr(), "WEIGHT": weight.data_ptr(),
                                "BIAS": bias.data_ptr(), "OUT": got.data_ptr()}
    assert got.is_contiguous() and got.dtype == dtype
    torch.testing.assert_close(got, composite(x, h, weight, bias, window_hw, (shift, shift)), rtol=0, atol=0)
    assert fa.launch_counts()["postnorm_residual"] == 1 and sum(fa.launch_counts().values()) == 1


def _ops(dtype=torch.bfloat16, c=16, window=4):
    return operands(1, 8, c, window, dtype)


def _args(x, h, w, b):
    return x, h, w, b, (4, 4), (2, 2)


def _misaligned(t):
    """A contiguous copy of t that starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("make,match", [
    (lambda: (lambda x, h, w, b: (x[0], h, w, b, (4, 4), (2, 2)))(*_ops()), r"x must be \(B, H, W, C\)"),
    (lambda: (lambda x, h, w, b: (x, h[:, :2], w, b, (4, 4), (2, 2)))(*_ops()), r"h must be \(B, nW, A, C\)"),
    (lambda: (lambda x, h, w, b: (x, h, w, b, (3, 4), (2, 2)))(*_ops()), "does not tile"),
    (lambda: (lambda x, h, w, b: (x, h, w, b, (4, 4), (8, 2)))(*_ops()), "outside the grid"),
    (lambda: (lambda x, h, w, b: (x, h, w, b, (4, 4), (-1, 0)))(*_ops()), "outside the grid"),
    (lambda: (lambda x, h, w, b: (x, h, w, b, None, (2, 2)))(*_ops(window=0)), "needs a window"),
    (lambda: (lambda x, h, w, b: (x, h[..., :8], w, b, None, (0, 0)))(*_ops(window=0)), "must be x's shape"),
    (lambda: (lambda x, h, w, b: (x, h, w[:8], b, (4, 4), (2, 2)))(*_ops()), r"weight must be \(C,\)"),
    (lambda: (lambda x, h, w, b: (x, h, w, b[None], (4, 4), (2, 2)))(*_ops()), r"bias must be \(C,\)"),
], ids=["x_dims", "h_shape", "window_tiling", "shift_past_grid", "negative_shift", "shift_without_window",
        "token_order_shape", "weight_shape", "bias_shape"])
def test_shape_refusals_on_both_routes(stub, monkeypatch, make, match):
    """Shapes are checked before the route is chosen: the plain route
    refuses them too."""
    for route in (False, True):
        monkeypatch.setattr(pr, "_device_route", lambda device, name, route=route: route)
        with pytest.raises(ValueError, match=match):
            pr.postnorm_residual(*make())
    assert not stub.calls and fa.launch_counts()["postnorm_residual"] == 0


@pytest.mark.parametrize("make,match", [
    (lambda: (lambda x, h, w, b: _args(x.transpose(1, 2), h, w, b))(*_ops()), "x must be contiguous"),
    (lambda: (lambda x, h, w, b: _args(x, h.transpose(1, 2).contiguous().transpose(1, 2), w, b))(*_ops()),
     "h must be contiguous"),
    (lambda: (lambda x, h, w, b: _args(x, h, w.repeat(2)[::2], b))(*_ops()), "weight must be contiguous"),
    (lambda: _args(*_ops(c=12)), "multiple of 16 bytes"),
    (lambda: _args(*_ops(c=3080)), "multiple of 16 bytes and at most 6144"),
    (lambda: _args(*_ops(dtype=torch.float64)), "takes float32, bfloat16 or float16"),
    (lambda: (lambda x, h, w, b: _args(x, h.float(), w, b))(*_ops()), "h is torch.float32"),
    (lambda: (lambda x, h, w, b: _args(x, h, w.float(), b))(*_ops()), "weight is torch.float32"),
    (lambda: (lambda x, h, w, b: _args(x, h, w, b.half()))(*_ops()), "bias is torch.float16"),
    (lambda: (lambda x, h, w, b: _args(_misaligned(x), h, w, b))(*_ops()), "16-byte aligned"),
    (lambda: (lambda x, h, w, b: _args(x, h, _misaligned(w), b))(*_ops()), "16-byte aligned"),
], ids=["x_strided", "h_strided", "weight_strided", "row_bytes_24", "row_too_wide", "float64", "h_dtype",
        "weight_dtype", "bias_dtype", "misaligned_x", "misaligned_weight"])
def test_kernel_route_refuses_what_the_kernel_does_not_read(stub, make, match):
    with pytest.raises(ValueError, match=match):
        pr.postnorm_residual(*make())
    assert not stub.calls and fa.launch_counts()["postnorm_residual"] == 0


def test_an_unsupported_device_raises():
    x, h, w, b = (t.to("meta") for t in _ops())
    with pytest.raises(ValueError, match="unsupported device meta"):
        pr.postnorm_residual(x, h, w, b, (4, 4), (2, 2))


def test_grad_requiring_operand_raises(stub):
    x, h, w, b = _ops(dtype=torch.float32)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        pr.postnorm_residual(x, h, w, b, (4, 4), (2, 2))
    with torch.no_grad():
        assert not pr.postnorm_residual(x, h, w, b, (4, 4), (2, 2)).requires_grad
    assert len(stub.calls) == 1


def test_a_refused_launch_raises(stub, monkeypatch):
    monkeypatch.setattr(stub, "mdpt_postnorm_residual", lambda *args: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        pr.postnorm_residual(*_args(*_ops()))
    assert all(n == 0 for n in fa.launch_counts().values())


def test_launch_counts_list_the_route():
    fa.reset_launch_counts()
    assert fa.launch_counts()["postnorm_residual"] == 0 and "postnorm_residual" in _build.ROUTES


FRAMES = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 60, 100, 3), np.uint8))
LAYERS = (2, 2, 2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_swinv2_forward_launches_two_per_block(stub, monkeypatch, dtype):
    """A tiny SwinV2 at 96x96 (window 4: grids 24 and 12 shift, 6 is one
    window, 3 clips): through the stub, two launches a block, the first
    with its stage's window and its block's shift, the second in token
    order, and the depth of the plain route's forward bit for bit."""
    model = make_swinv2_dpt((16, 32, 64, 128), (2, 4, 4, 8), LAYERS, (16, 16), (4, 4), (None,) * 4, 16,
                            dtype=dtype, device="cpu")
    got = model.inference_rgb_device(FRAMES, (96, 96))
    assert fa.launch_counts()["postnorm_residual"] == 2 * sum(LAYERS)
    grids = [24, 24, 12, 12, 6, 6, 3, 3]
    windows = [(4, 4)] * 4 + [(6, 6)] * 2 + [(3, 3)] * 2
    shifts = [(0, 0), (2, 2), (0, 0), (2, 2)] + [(0, 0)] * 4
    want = [c for g, w, s in zip(grids, windows, shifts) for c in ((g, w, s), (g, (g, g), (0, 0)))]
    assert [(c["sizes"][1], c["window"], c["shift"]) for c in stub.calls] == want
    monkeypatch.setattr(pr, "_device_route", lambda device, name: True)
    torch.testing.assert_close(got, model.inference_rgb_device(FRAMES, (96, 96)), rtol=0, atol=0)
    assert fa.launch_counts()["postnorm_residual"] == 2 * sum(LAYERS)


def _kernel_names() -> list:
    """The demangled names a device trace shows for each instance of the
    source's ``__global__`` function, its template arguments and parameter
    type included, as the benchmark's trace reads them."""
    src = CU_SOURCE.read_text()
    (name, arg), = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(const (\w+)", src)
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    groups = [(int(lanes), consts.get(k) or int(k), "true") for lanes, k in re.findall(r"launch_group<T, (\d+), (\w+)>", src)]
    groups.append((32, consts["MAX_VECTORS"] // 32, "false"))  # the general instance
    assert len(groups) == 7
    return [f"void (anonymous namespace)::{name}<{t}, {lanes}, {chunks}, {exact}>((anonymous namespace)::{arg})"
            for t in ("float", "__nv_bfloat16", "__half") for lanes, chunks, exact in groups]


def test_kernel_name_counts_as_encoder_glue():
    """No substring of ``attention.roofline_pct``'s ``PATTERNS`` or of
    ``encoder.glue_device_ms``'s ``PRODUCTS`` lies in any instance's name:
    the benchmark counts the pass in the encoder's glue, where the
    LayerNorms, adds, copies and rolls it replaces were counted."""
    patterns = spec.metric_reader("attention.roofline_pct").PATTERNS
    products = spec.metric_reader("encoder.glue_device_ms").PRODUCTS
    names = _kernel_names()
    assert len(names) == 21 and any("postnorm_residual_sm90<__nv_bfloat16, 8, 3, true>" in n for n in names)
    assert not [(n, p) for n in names for p in patterns + products if p in n]
