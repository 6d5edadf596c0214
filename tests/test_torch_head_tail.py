"""The port's fused depth-head tail (``ops/kernels/head_tail.py``): its
plain version, which the wrapper runs for CPU tensors, against the JAX
package's Pallas kernel (``experiments/pallas_head_conv.py``) in interpret
mode on the same numpy inputs, against the head it stands beside
(``Head.tail``), and the wrapper's argument checks and pointer arithmetic
through a stub of the kernel library.

Tolerance: float32 rtol 1e-5 / atol 1e-6, as tests/test_head_conv_kernel.py
holds the Pallas kernel to the unfused ops: the two differ only in float32
summation order."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.pallas_head_conv import fused_head_tail as jax_fused_head_tail
from muggled_dpt_tpu_torch.models.dpt_neck import Head
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import head_tail as ht

TOL = dict(rtol=1e-5, atol=1e-6)
CU_SOURCE = Path(ht.__file__).resolve().parents[2] / "csrc" / "head_tail.cu"
CO = 32


def _inputs(b, ci, h, w, seed=0):
    """An NCHW map and the tail's weights in torch layout, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, ci, h, w)) * 0.3).astype(np.float32)
    conv_w = (rng.standard_normal((CO, ci, 3, 3)) * 0.2).astype(np.float32)
    conv_b = (rng.standard_normal(CO) * 0.2).astype(np.float32)
    proj_w = (rng.standard_normal((1, CO, 1, 1)) * 0.3).astype(np.float32)
    proj_b = (rng.standard_normal(1) * 0.1).astype(np.float32)
    return x, [conv_w, conv_b, proj_w, proj_b]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax(x_nchw, params, is_metric):
    """The Pallas kernel, one NHWC image at a time (it takes B = 1)."""
    conv_w, conv_b, proj_w, proj_b = params
    ck = jnp.asarray(conv_w.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    pk = jnp.asarray(proj_w[:, :, 0, 0].T)  # (1, 32, 1, 1) -> (32, 1)
    outs = [
        jax_fused_head_tail(jnp.asarray(img.transpose(1, 2, 0)[None]), ck, jnp.asarray(conv_b), pk, jnp.asarray(proj_b),
                            is_metric=is_metric, interpret=True)
        for img in x_nchw
    ]
    return np.concatenate([np.asarray(o) for o in outs])


@pytest.mark.parametrize("b,ci,h,w,metric", [(1, 16, 40, 56, False), (1, 16, 37, 52, True), (2, 32, 19, 23, True)])
def test_plain_version_matches_jax_kernel(b, ci, h, w, metric):
    x, params = _inputs(b, ci, h, w)
    want = _jax(x, params, metric)
    got = ht.fused_head_tail_reference(_t(x), *(_t(p) for p in params), is_metric=metric)
    assert tuple(got.shape) == want.shape == (b, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a CPU tensor takes the plain version through the wrapper
    torch.testing.assert_close(ht.fused_head_tail(_t(x), *(_t(p) for p in params), is_metric=metric), got, rtol=0, atol=0)


@pytest.mark.parametrize("metric", [False, True])
def test_plain_version_equals_head_tail(metric):
    """In float32 the plain version is the head's tail (Head.tail: conv_mid,
    ReLU, proj, ReLU or sigmoid) on the head's own tensors."""
    head = Head(32, 14 / 8, metric)
    for p in head.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = _t(_inputs(2, 16, 21, 30, seed=5)[0])
    with torch.no_grad():
        want = head.tail(x)
        got = ht.fused_head_tail(x, head.conv_mid.weight, head.conv_mid.bias, head.proj.weight, head.proj.bias, metric)
    assert got.shape == want.shape == (2, 21, 30)
    torch.testing.assert_close(got, want, **TOL)
    if metric:
        assert float(got.min()) > 0.0 and float(got.max()) < 1.0


def test_plain_version_bf16_rounds_once():
    x, params = _inputs(1, 16, 12, 17, seed=6)
    got = ht.fused_head_tail_reference(_t(x, torch.bfloat16), *(_t(p, torch.bfloat16) for p in params), is_metric=True)
    want = ht.fused_head_tail_reference(_t(_t(x, torch.bfloat16).float()), *(_t(p, torch.bfloat16).float() for p in params),
                                        is_metric=True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_cpu_calls_count_no_launch():
    fa.reset_launch_counts()
    x, params = _inputs(1, 16, 9, 9)
    ht.fused_head_tail(_t(x), *(_t(p) for p in params))
    assert fa.launch_counts()["head_tail"] == 0


def test_bad_shapes_raise():
    x, params = _inputs(1, 16, 9, 9)
    x, params = _t(x), [_t(p) for p in params]
    for i, bad in ((0, params[0][:16]), (0, params[0][:, :8]), (0, params[0][..., :1, :1]), (1, params[1][:8]),
                   (2, params[2][:, :16]), (3, torch.zeros(2))):
        args = list(params)
        args[i] = bad
        with pytest.raises(ValueError):
            ht.fused_head_tail(x, *args)
    with pytest.raises(ValueError):
        ht.fused_head_tail(x[0], *params)


def test_kernel_launcher_refuses_what_it_cannot_take():
    """What the CUDA kernel cannot take raises before any launch: another
    dtype, mixed dtypes, a map that is not contiguous NCHW, a grid past
    CUDA's limits."""

    def refused(x, params):
        with pytest.raises(ValueError):
            b, _, h, w = x.shape
            ht._launch(x, params, torch.empty(b, h, w, dtype=x.dtype), False)

    x, params = _inputs(1, 16, 9, 9)
    x16, p16 = _t(x, torch.bfloat16), [_t(p, torch.bfloat16) for p in params]
    refused(x16.half(), [p.half() for p in p16])
    refused(x16.float(), p16)  # map and weights of two dtypes
    refused(x16.contiguous(memory_format=torch.channels_last), p16)  # NHWC memory
    refused(x16.expand(65536, 16, 9, 9), p16)  # batch past 65535


def _slots() -> dict:
    """``enum Slot`` of csrc/head_tail.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", CU_SOURCE.read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


class StubLibrary:
    """Stands in for the kernel library: reads the int64 argument array as
    the C entry does, views each contiguous tensor at its address and runs
    the plain version into ``out``."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    @staticmethod
    def _view(addr, shape, dtype):
        n = int(np.prod(shape))
        buf = (ctypes.c_byte * (n * torch.empty((), dtype=dtype).element_size())).from_address(addr)
        return torch.frombuffer(buf, dtype=dtype).view(shape)

    def mdpt_head_tail(self, args_ptr, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        b, ci, h, w, co = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_CHANNELS", "SLOT_HEIGHT", "SLOT_WIDTH", "SLOT_OUT_CHANNELS"))
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        shapes = {"SLOT_X": (b, ci, h, w), "SLOT_CONV_W": (co, ci, 3, 3), "SLOT_CONV_B": (co,), "SLOT_PROJ_W": (1, co, 1, 1),
                  "SLOT_PROJ_B": (1,), "SLOT_OUT": (b, h, w)}
        t = {k: self._view(a[s[k]], shape, dtype) for k, shape in shapes.items()}
        metric = bool(a[s["SLOT_IS_METRIC"]])
        self.calls.append({"shape": (b, ci, h, w), "co": co, "dtype": dtype, "metric": metric})
        params = [t[k] for k in ("SLOT_CONV_W", "SLOT_CONV_B", "SLOT_PROJ_W", "SLOT_PROJ_B")]
        t["SLOT_OUT"].copy_(ht.fused_head_tail_reference(t["SLOT_X"], *params, is_metric=metric))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    recorded = {}

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        recorded["values"] = [0 if x is None else x for x in values]
        return array.array(code, recorded["values"])

    monkeypatch.setattr(ht, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(ht, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    lib.recorded = recorded
    return lib


@pytest.mark.parametrize("dtype,shape,metric", [(torch.float32, (2, 16, 19, 23), False), (torch.bfloat16, (1, 32, 37, 52), True)])
def test_wrapper_arithmetic_through_stub_library(stub, dtype, shape, metric):
    """The kernel route's addresses, shape and activation flag, read back by
    a stub library that runs the plain version: the result equals the plain
    version on the original tensors."""
    x, params = _inputs(*shape, seed=7)
    x, params = _t(x, dtype), [_t(p, dtype) for p in params]
    fa.reset_launch_counts()
    got = ht.fused_head_tail(x, *params, is_metric=metric)
    assert fa.launch_counts()["head_tail"] == 1 and len(stub.calls) == 1
    assert len(stub.recorded["values"]) == stub.slots["NUM_SLOTS"]
    assert stub.calls[0] == {"shape": shape, "co": CO, "dtype": dtype, "metric": metric}
    want = ht.fused_head_tail_reference(x, *params, is_metric=metric)
    assert got.shape == want.shape == (shape[0], *shape[2:]) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
