"""The neck's bilinear align_corners=True upsample (``ops/kernels/upsample.py``,
``csrc/upsample_bilinear_ac.cu``) on the CPU: the wrapper's pointer, stride,
size, layout and dtype arithmetic through a stub of the kernel library that
runs ``F.interpolate`` on the memory it is handed, its argument checks and
autograd guard, its launch counts, and the neck's routing (``use_kernel``,
``plain_attention``). The kernel itself runs only on the card
(``chip_smoke.py:phase_upsample``). Every comparison is exact: the stub and
the CPU route compute ``F.interpolate`` itself."""

import array
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from muggled_dpt_tpu_torch import make_depthanythingv2_dpt
from muggled_dpt_tpu_torch.models.dpt_neck import FusionBlock, Head
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import upsample as up
from muggled_dpt_tpu_torch.parallel.train import plain_attention

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
CU_SOURCE = Path(up.__file__).resolve().parents[2] / "csrc" / "upsample_bilinear_ac.cu"
DTYPE_CODES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
# the neck's five upsamples, (in side, out side, channels), in each cell: DA-V2 at 504 (grid 36) and
# 1428 (grid 102), BEiT at 512 (grid 32); four fusion 2x upsamples at 256 channels, then the head's at 128
NECK_SHAPES = {
    "dav2_504": [(18, 36, 256), (36, 72, 256), (72, 144, 256), (144, 288, 256), (288, 504, 128)],
    "beit_512": [(16, 32, 256), (32, 64, 256), (64, 128, 256), (128, 256, 256), (256, 512, 128)],
    "dav2_1428": [(51, 102, 256), (102, 204, 256), (204, 408, 256), (408, 816, 256), (816, 1428, 128)],
}
CHANNEL_CAP = 8  # the stub computes on the CPU: the neck's sides at a few channels keep it fast
CASES = [(cell, i, (s_in, s_in), (s_out, s_out), min(c, CHANNEL_CAP), torch.bfloat16)
         for cell, shapes in NECK_SHAPES.items() for i, (s_in, s_out, c) in enumerate(shapes)]
CASES += [
    ("ragged", 0, (5, 7), (13, 9), 12, torch.float16),  # channels no multiple of 8, sides of neither
    ("one_pixel", 0, (1, 1), (1, 1), 8, torch.float32),  # scale 0 on both axes, and the copy of a same-size output
    ("one_pixel_up", 0, (1, 1), (2, 2), 8, torch.bfloat16),
    ("odd_width", 0, (6, 11), (12, 21), 16, torch.float32),  # rows no multiple of 16 bytes
]


def _slots() -> dict:
    """``enum Slot`` of csrc/upsample_bilinear_ac.cu: name -> index."""
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


def _dense_strides(b, c, h, w, layout):
    return (c * h * w, 1, w * c, c) if layout == up.LAYOUT_CHANNELS_LAST else (c * h * w, h * w, w, 1)


class StubLibrary:
    """Stands in for the kernel library: reads the int64 argument array as
    the C entry does, views the input at its address through the strides it
    was given and the output as the dense map of its layout, and writes
    ``F.interpolate`` of the one into the other."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    def mdpt_upsample_bilinear_ac(self, args_ptr, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        b, c, h, w, ho, wo = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_CHANNELS", "SLOT_IN_H", "SLOT_IN_W", "SLOT_OUT_H",
                                                  "SLOT_OUT_W"))
        layout, dtype = a[s["SLOT_LAYOUT"]], DTYPE_CODES[a[s["SLOT_DTYPE"]]]
        strides = tuple(a[s[k]] for k in ("SLOT_STRIDE_B", "SLOT_STRIDE_C", "SLOT_STRIDE_H", "SLOT_STRIDE_W"))
        x = _view(a[s["SLOT_X"]], (b, c, h, w), strides, dtype)
        out = _view(a[s["SLOT_OUT"]], (b, c, ho, wo), _dense_strides(b, c, ho, wo, layout), dtype)
        out.copy_(F.interpolate(x, size=(ho, wo), mode="bilinear", align_corners=True))
        self.calls.append({"sizes": (b, c, h, w, ho, wo), "layout": layout, "dtype": dtype, "strides": strides})
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    recorded = {}

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        recorded["values"] = [0 if x is None else x for x in values]
        return array.array(code, recorded["values"])

    monkeypatch.setattr(up, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(up, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa.reset_launch_counts()
    lib.recorded = recorded
    return lib


def _map(b, c, hw, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, *hw, generator=g).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("cell,index,in_hw,out_hw,channels,dtype", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_wrapper_arithmetic_through_stub_library(stub, cell, index, in_hw, out_hw, channels, dtype, channels_last):
    """The kernel route's addresses, strides, sizes, layout and dtype code,
    read back by a stub that runs ``F.interpolate`` on the memory it was
    handed: the result equals ``F.interpolate`` on the original map, in the
    same memory format, counted on the layout's route."""
    b = 1 if cell == "dav2_1428" else 2
    x = _map(b, channels, in_hw, dtype, channels_last, seed=index)
    got = up.upsample_bilinear_ac(x, out_hw)
    want = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)
    layout = up.LAYOUT_NCHW if x.is_contiguous() else up.LAYOUT_CHANNELS_LAST  # a 1 x 1 map is NCHW in both
    assert stub.calls == [{"sizes": (b, channels, *in_hw, *out_hw), "layout": layout, "dtype": dtype,
                           "strides": x.stride()}]
    assert len(stub.recorded["values"]) == stub.slots["NUM_SLOTS"]
    assert stub.recorded["values"][stub.slots["SLOT_X"]] == x.data_ptr()
    assert stub.recorded["values"][stub.slots["SLOT_OUT"]] == got.data_ptr()
    assert got.shape == want.shape and got.dtype == dtype and got.stride() == want.stride()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    counts = fa.launch_counts()
    assert (counts["upsample_ac"], counts["upsample_ac_nchw"]) == ((0, 1) if layout == up.LAYOUT_NCHW else (1, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "nchw"])
def test_cpu_route_is_f_interpolate_and_launches_nothing(dtype, channels_last):
    fa.reset_launch_counts()
    x = _map(2, 16, (9, 12), dtype, channels_last)
    got = up.upsample_bilinear_ac(x, (18, 21))
    want = F.interpolate(x, size=(18, 21), mode="bilinear", align_corners=True)
    assert got.dtype == dtype and got.stride() == want.stride()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(n == 0 for n in fa.launch_counts().values())


@pytest.mark.parametrize("make", [
    lambda: torch.randn(2, 4, 3, 3).transpose(1, 2),  # dense, but in neither memory format
    lambda: torch.randn(2, 4, 6, 6)[..., ::2],  # width strided
    lambda: torch.randn(2, 4, 6, 6).contiguous(memory_format=torch.channels_last)[:, :3],  # a channel slice
    lambda: torch.randn(1, 6, 1, 4).transpose(1, 3),  # channels-last strides torch reads as NCHW
], ids=["permuted", "strided_width", "channel_slice", "ambiguous"])
def test_layouts_the_kernel_does_not_read_raise(stub, make):
    with pytest.raises(ValueError, match="channels-last or NCHW-contiguous"):
        up.upsample_bilinear_ac(make(), (8, 8))
    assert not stub.calls


def test_bad_rank_dtype_or_size_raises(stub):
    for x, hw, match in [(torch.randn(4, 6, 6), (8, 8), "must be"), (torch.randn(1, 2, 4, 6, 6), (8, 8), "must be"),
                         (torch.randn(1, 4, 6, 6, dtype=torch.float64), (8, 8), "takes float32"),
                         (torch.ones(1, 4, 6, 6, dtype=torch.int32), (8, 8), "takes float32"),
                         (torch.randn(1, 4, 6, 6), (0, 8), "bad output size")]:
        with pytest.raises(ValueError, match=match):
            up.upsample_bilinear_ac(x, hw)
    assert not stub.calls


def test_output_memory_format_follows_torch_on_ambiguous_strides(stub):
    """Maps whose strides fit both formats (sides of 1): the output takes
    the format ``F.interpolate`` gives, from torch's stride rule."""
    cases = [torch.randn(3, 8, 1, 1), torch.randn(3, 1, 5, 7).contiguous(memory_format=torch.channels_last),
             torch.randn(3, 1, 1, 8).permute(0, 3, 1, 2), torch.randn(1, 8, 5, 7),
             torch.randn(1, 5, 7, 8).permute(0, 3, 1, 2), torch.randn(3, 1, 5, 7)]
    for x in cases:
        got = up.upsample_bilinear_ac(x, (3, 2))
        want = F.interpolate(x, size=(3, 2), mode="bilinear", align_corners=True)
        assert got.stride() == want.stride(), (x.shape, x.stride())
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_grad_requiring_operand_raises(stub):
    x = torch.randn(1, 8, 4, 4).requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        up.upsample_bilinear_ac(x, (8, 8))
    with torch.no_grad():
        assert not up.upsample_bilinear_ac(x, (8, 8)).requires_grad
    assert len(stub.calls) == 1


def test_a_refused_launch_raises(stub, monkeypatch):
    monkeypatch.setattr(stub, "mdpt_upsample_bilinear_ac", lambda *args: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        up.upsample_bilinear_ac(torch.randn(1, 8, 4, 4), (8, 8))
    assert all(n == 0 for n in fa.launch_counts().values())


def test_launch_counts_list_both_routes():
    fa.reset_launch_counts()
    counts = fa.launch_counts()
    assert counts["upsample_ac"] == counts["upsample_ac_nchw"] == 0
    assert {"upsample_ac", "upsample_ac_nchw"} <= set(_build.ROUTES)


@pytest.fixture(scope="module")
def da_v2():
    return make_depthanythingv2_dpt(64, 2, 4, (8, 16, 32, 64), (8, 8), 16, seed=0, device=DEVICE)


def test_neck_modules_take_the_familys_switch(da_v2):
    neck = [*da_v2.net.fusion, da_v2.net.head]
    assert all(isinstance(m, (FusionBlock, Head)) and m.use_kernel for m in neck)
    plain = make_depthanythingv2_dpt(64, 2, 4, (8, 16, 32, 64), (8, 8), 16, seed=0, device=DEVICE,
                                     enable_optimizations=False)
    assert not any(m.use_kernel for m in [*plain.net.fusion, plain.net.head])


def test_plain_attention_switches_the_neck_off_and_restores_it(da_v2):
    neck = [*da_v2.net.fusion, da_v2.net.head]
    with plain_attention(da_v2.net):
        assert not any(m.use_kernel for m in neck)
    assert all(m.use_kernel for m in neck)


@pytest.mark.parametrize("batch", [1, 2])
def test_cpu_forward_is_bit_equal_with_use_kernel_on_and_off(da_v2, batch):
    """On the CPU the neck runs ``F.interpolate`` either way: the same depth
    bit for bit, and no launch."""
    x = torch.randn(batch, 3, 112, 140, generator=torch.Generator().manual_seed(batch))
    fa.reset_launch_counts()
    with torch.no_grad():
        on = da_v2.net(x)
        with plain_attention(da_v2.net):
            off = da_v2.net(x)
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    assert all(n == 0 for n in fa.launch_counts().values())
