"""The port's SwinV2 window attention (``ops/kernels/window_attention.py``):
its plain version, which the wrapper runs for CPU tensors, against the JAX
package's Pallas window kernel in interpret mode on the same numpy inputs
(the cases of tests/test_window_attention_kernel.py), and the wrapper's
argument checks and pointer, stride and window arithmetic through a stub of
the kernel library.

Tolerance: atol = rtol = 2e-5 in float32, as the JAX package holds its own
kernel to its einsum reference: the two differ only in float32 summation
order. bfloat16: 2e-2, one bf16 ulp at outputs in [2, 4): the weights are
rounded to bf16 before the PV product in both, and the products are summed
in another order."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.ops.pallas.window_attention import window_flash_attention
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, NW, H, D = 2, 4, 3, 32
CU_SOURCE = Path(wa.__file__).resolve().parents[2] / "csrc" / "window_attention.cu"


def _inputs(area, with_mask, seed=0, b=B, nw=NW, h=H, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, nw, area, h, d)).astype(np.float32) for _ in range(3))
    cpb = rng.standard_normal((h, area, area)).astype(np.float32)
    mask = rng.choice([0.0, -100.0], size=(nw, area, area)).astype(np.float32) if with_mask else None
    return q, k, v, cpb, mask


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("area", [16, 36, 150])  # 150: a ragged last key tile
@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_version_matches_jax_kernel(area, with_mask):
    q, k, v, cpb, mask = _inputs(area, with_mask)
    want = np.asarray(window_flash_attention(q, k, v, cpb, mask, interpret=True))
    got = wa.window_attention_reference(*(_t(a) for a in (q, k, v, cpb, mask)))
    assert tuple(got.shape) == want.shape == (B, NW, area, H, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a CPU tensor takes the plain version through the wrapper
    torch.testing.assert_close(wa.window_attention(*(_t(a) for a in (q, k, v, cpb, mask))), got, rtol=0, atol=0)


@pytest.mark.parametrize("area", [36, 150])
def test_plain_version_matches_jax_kernel_bf16(area):
    q, k, v, cpb, mask = _inputs(area, True, seed=1)
    want = window_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, cpb, mask)), interpret=True)
    got = wa.window_attention_reference(*(_t(a, torch.bfloat16) for a in (q, k, v, cpb, mask)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **BF16_TOL)


def test_cpu_calls_count_no_launch():
    fa.reset_launch_counts()
    q, k, v, cpb, mask = (_t(a) for a in _inputs(16, True))
    wa.window_attention(q, k, v, cpb, mask)
    wa.window_attention(q, k, v, cpb)
    assert fa.launch_counts()["window"] == 0


def test_bad_shapes_raise():
    q, k, v, cpb, mask = (_t(a) for a in _inputs(16, True))
    for bad in (
        {"mask": mask[:3]},  # wrong window count
        {"mask": mask[:, :15]},
        {"cpb": cpb[:2]},  # wrong head count
        {"cpb": cpb[:, :, :15]},
        {"k": k[:, :, :15]},
        {"v": v[0]},
    ):
        kw = {"q": q, "k": k, "v": v, "cpb": cpb, "mask": mask, **bad}
        with pytest.raises(ValueError):
            wa.window_attention(**kw)


def test_kernel_launcher_refuses_what_it_cannot_take():
    """What the CUDA kernel cannot take raises before any launch: a head
    width other than 32, another dtype (float64: float16 is taken, and packs
    dtype code 2), a head dim that is not contiguous, rows that are not
    16-byte aligned, a grid past CUDA's limits."""
    cpu = torch.device("cpu")

    def refused(q, k=None, cpb=None):
        k = q if k is None else k
        b, nw, a, h, _ = q.shape
        cpb = torch.zeros(h, a, a) if cpb is None else cpb
        with pytest.raises(ValueError):
            specs = [wa._operand(name, t, cpu, q.dtype) for name, t in (("q", q), ("k", k), ("v", q))]
            code, c, m = wa._bias_operands(cpb, None, cpu)
            wa._launch(tuple(q.shape), q.dtype, cpu, *specs, specs[0], code, c, m)

    def bnwahd(d=D, dtype=torch.bfloat16, b=1, nw=2, h=2):
        return torch.zeros(b, nw, 16, h, d, dtype=dtype)

    refused(bnwahd(d=64))
    refused(bnwahd(d=16))
    refused(bnwahd(dtype=torch.float64))
    refused(bnwahd(), k=bnwahd(dtype=torch.float32))  # operands of two dtypes
    refused(torch.zeros(1, 2, 16, 2, 2 * D, dtype=torch.bfloat16)[..., ::2])  # head dim strided
    refused(torch.zeros(1, 2, 16, 2, D + 4, dtype=torch.bfloat16)[..., :D])  # rows 8 B off 16 B alignment
    refused(bnwahd(), cpb=torch.zeros(2, 16, 16, dtype=torch.float64))  # a bias dtype the kernel has no instance for
    refused(torch.zeros(8193, 8, 1, 1, D, dtype=torch.bfloat16).expand(8193, 8, 16, 1, D))  # B * nW past 65535
    # float16 is taken: q, k, v and a float16 bias pack code 2; a float16 bias beside bf16 q goes over as float32
    half = bnwahd(dtype=torch.float16)
    assert [wa._operand(name, half, cpu, torch.float16)[0] for name in "qkv"] == [half.data_ptr()] * 3
    assert wa._bias_operands(torch.zeros(2, 16, 16, dtype=torch.float16), None, cpu, torch.float16)[0] == 2
    code, cpb, _ = wa._bias_operands(torch.zeros(2, 16, 16, dtype=torch.float16), None, cpu, torch.bfloat16)
    assert (code, cpb.dtype) == (0, torch.float32)


def _slots() -> dict:
    """``enum Slot`` of csrc/window_attention.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", CU_SOURCE.read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


class StubLibrary:
    """Stands in for the kernel library: reads the int64 argument array as
    the C entry does, views the memory at each address with the strides it
    was given, and runs the kernel's loop over (batch * window) with the
    plain version into ``out``."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    @staticmethod
    def _view(addr, sizes, strides, dtype):
        extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
        buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)

    def mdpt_window_attention(self, args_ptr, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        b, nw, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_WINDOWS", "SLOT_AREA", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype, bias_dtype = ([torch.float32, torch.bfloat16, torch.float16][a[s[k]]] for k in ("SLOT_DTYPE", "SLOT_BIAS_DTYPE"))
        q, k, v, o = (self._view(a[s[k]], (b, nw, n, h, d), [*a[s[k] + 1 : s[k] + 5], 1], dtype)
                      for k in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O"))
        c = s["SLOT_CPB"]
        cpb = self._view(a[c], (h, n, n), (a[c + 1], a[c + 2], 1), bias_dtype)
        m = s["SLOT_MASK"]
        mask = self._view(a[m], (nw, n, n), (a[m + 1], a[m + 2], 1), bias_dtype) if a[m] else None
        self.calls.append({"pairable": [t.stride(1) % 2 == 0 for t in (cpb, mask) if t is not None], "bias_dtype": bias_dtype})
        for z in range(b * nw):  # the CUDA grid's z axis: batch-major, window = z mod nW
            bi, w = divmod(z, nw)
            sel = (slice(bi, bi + 1), slice(w, w + 1))
            o[sel] = wa.window_attention_reference(q[sel], k[sel], v[sel], cpb, None if mask is None else mask[w : w + 1])
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    recorded = {}

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        recorded["values"] = [0 if x is None else x for x in values]
        return array.array(code, recorded["values"])

    monkeypatch.setattr(wa, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(wa, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    lib.recorded = recorded
    return lib


@pytest.mark.parametrize(
    "dtype,bias_dtypes,area,views",
    [
        (torch.float32, (torch.float32, torch.float32), 36, False),
        (torch.float32, (torch.bfloat16, torch.float32), 25, False),  # odd area: rows padded; mixed: float32
        (torch.bfloat16, (torch.bfloat16, torch.bfloat16), 16, True),  # q, k, v as views of one qkv
        (torch.bfloat16, (torch.float32, None), 150, True),
    ],
)
def test_wrapper_arithmetic_through_stub_library(stub, dtype, bias_dtypes, area, views):
    """The kernel route's addresses, strides, window index and bias
    layout, read back by a stub library that runs the plain version: the
    result equals the plain version on the original tensors."""
    q, k, v, cpb, mask = _inputs(area, bias_dtypes[1] is not None, seed=3)
    if views:
        qkv = _t(np.stack([q, k, v], axis=3), dtype)  # (B, nW, A, 3, H, D), q k v strided views
        q, k, v = qkv.unbind(3)
    else:
        q, k, v = (_t(a, dtype) for a in (q, k, v))
    cpb, mask = _t(cpb, bias_dtypes[0]), _t(mask, bias_dtypes[1] or torch.float32)
    fa.reset_launch_counts()
    got = wa.window_attention(q, k, v, cpb, mask)
    assert fa.launch_counts()["window"] == 1 and len(stub.calls) == 1
    assert len(stub.recorded["values"]) == stub.slots["NUM_SLOTS"]
    assert all(stub.calls[0]["pairable"])  # every bias row starts at an even element
    assert stub.calls[0]["bias_dtype"] == (bias_dtypes[0] if len(set(bias_dtypes) - {None}) == 1 else torch.float32)
    want = wa.window_attention_reference(q, k, v, cpb, mask)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
