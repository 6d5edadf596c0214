"""The sm_90 SwinV2 window kernel's route (``csrc/window_attention_sm90.cu``
behind ``mdpt_window_attention``) without a card: the plain version against
the JAX package's Pallas window kernel in interpret mode at the new kernel's
tile edges (192-row q tiles, 64-key tiles), which layouts the C entry sends
to it, and the wrapper's arguments read back by a stub library that checks
what the kernel's tensor maps require.

Tolerance: atol = rtol = 2e-5 in float32, as tests/test_torch_window_attention.py
holds the same two functions: they differ only in float32 summation order."""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from muggled_dpt_tpu.ops.pallas.window_attention import window_flash_attention
from muggled_dpt_tpu_torch import make_swinv2_dpt
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa
from muggled_dpt_tpu_torch.tools import window_sm90_variants as wv

TOL = dict(rtol=2e-5, atol=2e-5)
D = 32
CSRC = Path(wa.__file__).resolve().parents[2] / "csrc"
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise


def _constants() -> dict:
    """The sm_90 kernel's tile constants, read from its source."""
    src = (CSRC / "window_attention_sm90.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) for name in ("CONSUMERS", "BKV")}


# The C entry's route choice in csrc/window_attention.cu, whitespace
# collapsed: the body of tma_readable, the operand sizes it is given, and the
# `sm90 =` expression. Sm90Stub transcribes exactly this text; a change to it
# fails test_stub_transcribes_the_c_entrys_route until the stub follows.
C_ROUTE = (
    "if (addr % 16 != 0) return false; for (int i = 0; i < dims; ++i) if (sizes[i] > 1 && (strides[i] <= 0 || "
    "strides[i] % 8 != 0 || strides[i] >= (1ll << 39))) return false; return true;",
    "const long long rows[4] = {batch, nw, n, num_heads}, bias_rows[2] = {num_heads, n}, mask_rows[2] = {nw, n};",
    "dtype == 1 && bias_dtype == 1 && (long long)nw * num_heads <= 65535 && tma_readable(q[0], q + 1, rows, 4) && "
    "tma_readable(k[0], k + 1, rows, 4) && tma_readable(v[0], v + 1, rows, 4) && tma_readable(o[0], o + 1, rows, 4) && "
    "tma_readable(c[0], c + 1, bias_rows, 2) && (mk[0] == 0 || tma_readable(mk[0], mk + 1, mask_rows, 2))",
)


def _c_route() -> tuple:
    """The route text of csrc/window_attention.cu, as C_ROUTE holds it."""
    src = (CSRC / "window_attention.cu").read_text()
    readable = re.search(r"bool tma_readable\([^)]*\) \{(.*?)\n\}", src, re.S)
    choice = re.search(r"(const long long rows\[4\].*?;)\s*const bool sm90 = (.*?);", src, re.S)
    return tuple(" ".join(text.split()) for text in (readable.group(1), choice.group(1), choice.group(2)))


def test_stub_transcribes_the_c_entrys_route():
    assert _c_route() == C_ROUTE


def _slots() -> dict:
    """``enum Slot`` of csrc/window_attention.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", (CSRC / "window_attention.cu").read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


def _inputs(area, with_mask, b=1, nw=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, nw, area, h, D)).astype(np.float32) for _ in range(3))
    cpb = rng.standard_normal((h, area, area)).astype(np.float32)
    mask = rng.choice([0.0, -100.0], size=(nw, area, area)).astype(np.float32) if with_mask else None
    return q, k, v, cpb, mask


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# 63-65 and 191-193 straddle the 64-key tiles and the 192-row q tile; 144
# and 576 are SwinV2-L-384's areas (stage 4 and stages 1-3)
@pytest.mark.parametrize("area", [63, 64, 65, 144, 191, 192, 193, 576])
@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_version_matches_jax_kernel_at_tile_edges(area, with_mask):
    q, k, v, cpb, mask = _inputs(area, with_mask, seed=area)
    want = np.asarray(window_flash_attention(q, k, v, cpb, mask, interpret=True))
    got = wa.window_attention_reference(*(_t(a) for a in (q, k, v, cpb, mask)))
    assert tuple(got.shape) == want.shape == (1, 2, area, 2, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


class Sm90Stub:
    """Stands in for the kernel library. Reads the int64 argument array as
    the C entry does and chooses the kernel as it does: the sm_90 kernel for
    bf16 q, k, v with bf16 biases whose every operand a tensor map can read.
    On that route it checks what the kernel's tensor maps require: the 5-D
    (D, H, A, nW, B) maps of q, k, v and out and the 3-D (A, A, H | nW) maps
    of the CPB and the mask need 16-byte aligned bases and non-zero strides
    of multiples of 16 bytes below 2^40 on every dim of size > 1, boxes of
    at most 256 per dim, an inner box of one swizzle span (64 B for rows of
    32 bf16, 128 B for 64 bias keys). Then it writes its choice to
    SLOT_ROUTE and runs the plain version into ``out``."""

    def __init__(self):
        self.slots, self.const, self.calls = _slots(), _constants(), []

    @staticmethod
    def _view(addr, sizes, strides, dtype):
        extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
        buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)

    @staticmethod
    def _readable(addr, strides, sizes) -> bool:  # csrc/window_attention.cu: tma_readable
        return addr % 16 == 0 and all(size == 1 or (0 < st and st % 8 == 0 and st < 2**39) for st, size in zip(strides, sizes))

    @staticmethod
    def _check_map(what, addr, dims, byte_strides, box, swizzle_bytes):
        """What cuTensorMapEncodeTiled takes of a bf16 map (byte_strides: of dims 1..)."""
        assert addr % 16 == 0, f"{what}: base {addr:#x} off 16 bytes"
        assert all(1 <= d < 2**32 for d in dims), f"{what}: dims {dims}"
        for d, st in zip(dims[1:], byte_strides):
            assert d == 1 or (st > 0 and st % 16 == 0 and st < 2**40), f"{what}: stride {st} B on a dim of {d}"
        assert all(1 <= x <= 256 for x in box), f"{what}: box {box}"
        assert box[0] * 2 == swizzle_bytes, f"{what}: inner box {box[0] * 2} B, swizzle {swizzle_bytes} B"

    def mdpt_window_attention(self, args_ptr, stream):
        s = self.slots
        raw = (ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr)
        a = list(raw)
        b, nw, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_WINDOWS", "SLOT_AREA", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype_code, bias_code = a[s["SLOT_DTYPE"]], a[s["SLOT_BIAS_DTYPE"]]
        dtype, bias_dtype = torch.float32 if dtype_code == 0 else torch.bfloat16, torch.float32 if bias_code == 0 else torch.bfloat16
        rows = {k: (a[s[k]], a[s[k] + 1 : s[k] + 5]) for k in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O")}
        c, m = s["SLOT_CPB"], s["SLOT_MASK"]
        cpb_addr, cpb_st = a[c], (a[c + 1], a[c + 2])
        mask_addr, mask_st = a[m], (a[m + 1], a[m + 2])
        sizes = (b, nw, n, h)
        sm90 = (dtype_code == 1 and bias_code == 1 and nw * h <= 65535
                and all(self._readable(addr, st, sizes) for addr, st in rows.values())
                and self._readable(cpb_addr, cpb_st, (h, n))
                and (mask_addr == 0 or self._readable(mask_addr, mask_st, (nw, n))))
        if sm90:
            bq, bkv = 64 * self.const["CONSUMERS"], self.const["BKV"]
            for (key, (addr, (sb, sw, sn, sh))), box_rows in zip(rows.items(), (bq, bkv, bkv, 64)):
                self._check_map(key, addr, (d, h, n, nw, b), [2 * x for x in (sh, sn, sw, sb)], (d, 1, box_rows, 1, 1), 64)
            self._check_map("cpb", cpb_addr, (n, n, h), [2 * cpb_st[1], 2 * cpb_st[0]], (64, bq, 1), 128)
            if mask_addr:
                self._check_map("mask", mask_addr, (n, n, nw), [2 * mask_st[1], 2 * mask_st[0]], (64, bq, 1), 128)
        raw[s["SLOT_ROUTE"]] = int(sm90)
        q, k, v, o = (self._view(addr, (b, nw, n, h, d), [*st, 1], dtype) for addr, st in rows.values())
        cpb = self._view(cpb_addr, (h, n, n), (*cpb_st, 1), bias_dtype)
        mask = self._view(mask_addr, (nw, n, n), (*mask_st, 1), bias_dtype) if mask_addr else None
        self.calls.append({"sm90": sm90, "bias_row_strides": [cpb_st[1], *(mask_st[1:] if mask_addr else ())]})
        o.copy_(wa.window_attention_reference(q, k, v, cpb, mask))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = Sm90Stub()
    real_array = wa.array.array

    def array(code, values):  # a CPU tensor's device index is None: the stub has no device
        return real_array(code, [0 if x is None else x for x in values])

    monkeypatch.setattr(wa, "array", types.SimpleNamespace(array=array))
    monkeypatch.setattr(wa, "_device_route", lambda device, name: False)
    monkeypatch.setattr(wa, "kernel_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa.reset_launch_counts()
    return lib


def _model_operands(area, nw, h, with_mask, dtype=torch.bfloat16, bias_dtype=torch.bfloat16, seed=1):
    """The window kernel's operands as the SwinV2 block hands them over:
    q_scaled and kf contiguous (B, nW, A, H, D), v a view of the qkv
    projection, cpb one block's layer of the cached (L, H, A, A) stack, the
    (nW, A, A) mask."""
    rng = np.random.default_rng(seed)
    qkv = _t(rng.standard_normal((2, nw, area, 3, h, D)).astype(np.float32), dtype)
    q, k, v = qkv.unbind(3)
    stack = _t(rng.standard_normal((2, h, area, area)).astype(np.float32), bias_dtype)
    mask = _t(rng.choice([0.0, -100.0], size=(nw, area, area)).astype(np.float32), bias_dtype) if with_mask else None
    return q.contiguous(), k.contiguous(), v, stack[1], mask


@pytest.mark.parametrize("area", [16, 25, 36, 144, 150])
@pytest.mark.parametrize("with_mask", [False, True])
def test_every_model_layout_takes_the_sm90_route(stub, area, with_mask):
    """bf16 operands laid out as the model sends them reach the sm_90
    kernel at every area, odd and even: the wrapper pads a bias whose rows
    are not 16-byte aligned (A = 25, 36, 150) to a multiple of 8."""
    args = _model_operands(area, 4, 2, with_mask)
    got = wa.window_attention(*args)
    assert wa.SLOT_ROUTE == stub.slots["SLOT_ROUTE"] == stub.slots["NUM_SLOTS"] - 1
    assert [call["sm90"] for call in stub.calls] == [True]
    assert all(st % 8 == 0 for st in stub.calls[0]["bias_row_strides"])
    counts = fa.launch_counts()
    assert (counts["window_sm90"], counts["window"]) == (1, 0)
    torch.testing.assert_close(got, wa.window_attention_reference(*args), rtol=0, atol=0)


@pytest.mark.parametrize(
    "dtype,bias_dtypes",
    [
        (torch.float32, (torch.float32, torch.float32)),
        (torch.float32, (torch.bfloat16, torch.bfloat16)),
        (torch.bfloat16, (torch.float32, torch.float32)),  # the inline CPB with the cache off
        (torch.bfloat16, (torch.bfloat16, torch.float32)),  # mixed: both biases go over as float32
        (torch.bfloat16, (torch.float32, torch.bfloat16)),
    ],
)
def test_float32_and_mixed_dtypes_stay_in_window_attention_cu(stub, dtype, bias_dtypes):
    q, k, v, cpb, mask = _model_operands(36, 4, 2, True, dtype)
    cpb, mask = cpb.to(bias_dtypes[0]), mask.to(bias_dtypes[1])
    got = wa.window_attention(q, k, v, cpb, mask)
    assert [call["sm90"] for call in stub.calls] == [False]
    assert (wa.window_attention.sm90_launches, wa.window_attention.launches) == (0, 1)
    torch.testing.assert_close(got, wa.window_attention_reference(q, k, v, cpb, mask), rtol=0, atol=0)


def test_layouts_tma_cannot_read_stay_in_window_attention_cu(stub):
    """Handed to the C entry as they are (``_launch``, past the wrapper's
    padding): bias rows 8 bytes off 16, and q broadcast over the batch
    (stride 0), go to window_attention.cu."""
    cpu = torch.device("cpu")
    q, k, v, cpb, mask = _model_operands(16, 4, 2, True)
    wide = torch.zeros(2, 16, 20, dtype=torch.bfloat16)
    wide[..., :16] = cpb
    odd_rows = wide[..., :16]  # rows of 20 elements: 40 bytes apart
    broadcast = q[:1].expand(2, *q.shape[1:])
    out = torch.empty_like(q)
    o = (out.data_ptr(), *out.stride()[:4])
    for qq, c in ((q, odd_rows), (broadcast, cpb)):
        specs = [wa._operand(name, t, cpu, qq.dtype) for name, t in (("q", qq), ("k", k), ("v", v))]
        assert wa._launch(tuple(q.shape), qq.dtype, cpu, *specs, o, 1, c, mask) is False
        torch.testing.assert_close(out, wa.window_attention_reference(qq, k, v, c, mask), rtol=0, atol=0)
    assert [call["sm90"] for call in stub.calls] == [False, False]
    # the same operands through the wrapper: the bias is padded, and an aligned q takes the sm_90 route
    wa.window_attention(q, k, v, odd_rows, mask)
    assert stub.calls[-1]["sm90"] and stub.calls[-1]["bias_row_strides"][0] == 16


def test_swinv2_bf16_forward_with_the_cache_runs_every_window_on_sm90(stub):
    """A head-width-32 toy SwinV2 in bf16 with the per-grid aux cache on:
    every window attention of the forward (2 blocks per stage, stage 4's
    2x2 windows included) reaches the sm_90 kernel."""
    model = make_swinv2_dpt((64, 128, 256, 512), (2, 4, 8, 16), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16,
                            dtype=torch.bfloat16, seed=3, device=DEVICE)
    img = np.random.default_rng(0).integers(0, 256, (150, 110, 3), dtype=np.uint8)
    depth = model.inference(img, 64)
    assert tuple(depth.shape) == (1, 64, 64) and bool(torch.isfinite(depth.float()).all())
    assert model._aux_cache  # the CPB stacks and masks were cached
    counts = fa.launch_counts()
    assert (counts["window_sm90"], counts["window"]) == (8, 0)
    assert all(call["sm90"] for call in stub.calls) and len(stub.calls) == 8


@pytest.mark.parametrize("name", list(wv.variants()))
def test_every_design_variant_applies_to_the_source(name):
    """tools/window_sm90_variants.py makes each design variant by text edits
    of the committed source: every edit still finds its text. The thread-
    block-cluster multicast lives only there, as such an edit."""
    src = (CSRC / "window_attention_sm90.cu").read_text()
    replacements, _ = wv.variants()[name]
    out = wv.variant_source(src, replacements)
    assert out.endswith(wv.ENTRY) and (out != src + wv.ENTRY) == bool(replacements)
    assert ("multicast::cluster" in out) == (name == "cluster 2") and "multicast::cluster" not in src
