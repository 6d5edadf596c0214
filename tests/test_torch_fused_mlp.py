"""The port's fused LayerNorm -> MLP -> LayerScale residual
(``ops/kernels/fused_mlp.py``): its plain version, which the wrapper runs for
CPU tensors, against the JAX package's Pallas kernel
(``experiments/pallas_fused_mlp.py``) in interpret mode on the same numpy
inputs, against the block it stands beside (``Block.mlp_residual``), and the
wrapper's argument checks and pointer arithmetic through a stub of the
kernel library.

Tolerances: float32 rtol 1e-4 / atol 1e-5, as tests/test_fused_mlp.py holds
the Pallas kernel to the unfused ops (its polynomial erf differs from the
exact erf by about 1.5e-7). bfloat16: rtol = atol = 1e-2, one bf16 ulp at
any output below 2, since both round the normalized rows, the GELU output and
the result at the same points but sum in another order."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.pallas_fused_mlp import fused_ln_mlp_residual as jax_fused_ln_mlp_residual
from muggled_dpt_tpu_torch.models.dinov2 import Block
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import fused_mlp as fm

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
CU_SOURCE = Path(fm.__file__).resolve().parents[2] / "csrc" / "fused_mlp.cu"


def _inputs(shape, hidden, seed=0):
    """x N(0, 1) and the block's parameters in torch layout, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = shape[-1]

    def w(*s, scale=0.05, shift=0.0):
        return (rng.standard_normal(s) * scale + shift).astype(np.float32)

    x = w(*shape, scale=1.0)
    params = [w(f, shift=1.0), w(f), w(hidden, f), w(hidden), w(f, hidden), w(f), w(f, shift=1.0)]
    return x, params


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax(x, params, dtype):
    ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls = (jnp.asarray(p, dtype) for p in params)
    return jax_fused_ln_mlp_residual(
        jnp.asarray(x, dtype), ln_w, ln_b, fc1_w.T, fc1_b, fc2_w.T, fc2_b, ls, block_rows=64, block_hidden=128, interpret=True
    )


@pytest.mark.parametrize("shape,hidden", [((2, 100, 64), 256), ((1, 37, 128), 512)])
def test_plain_version_matches_jax_kernel(shape, hidden):
    x, params = _inputs(shape, hidden)
    want = np.asarray(_jax(x, params, jnp.float32))
    got = fm.fused_ln_mlp_residual_reference(_t(x), *(_t(p) for p in params))
    assert tuple(got.shape) == want.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a CPU tensor takes the plain version through the wrapper
    torch.testing.assert_close(fm.fused_ln_mlp_residual(_t(x), *(_t(p) for p in params)), got, rtol=0, atol=0)


def test_plain_version_matches_jax_kernel_bf16():
    x, params = _inputs((2, 100, 64), 256, seed=1)
    want = _jax(x, params, jnp.bfloat16)
    got = fm.fused_ln_mlp_residual_reference(_t(x, torch.bfloat16), *(_t(p, torch.bfloat16) for p in params))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **BF16_TOL)


def _block(f, hidden_params, seed=2):
    """A GELU block whose norm2, MLP and ls2 hold the given numpy parameters."""
    block = Block(f, 1)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.05)
    ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls = (_t(p) for p in hidden_params)
    with torch.no_grad():
        block.norm2.weight.copy_(ln_w), block.norm2.bias.copy_(ln_b)
        block.mlp.fc1.weight.copy_(fc1_w), block.mlp.fc1.bias.copy_(fc1_b)
        block.mlp.fc2.weight.copy_(fc2_w), block.mlp.fc2.bias.copy_(fc2_b)
        block.ls2.copy_(ls)
    return block


@pytest.mark.parametrize("f", [64, 128])
def test_plain_version_equals_block_mlp_residual(f):
    """In float32 the plain version is the block's second half: the same ops
    (Block.mlp_residual) on the block's own tensors, to summation order."""
    x, params = _inputs((2, 29, f), 4 * f, seed=f)
    block = _block(f, params)
    m, n2 = block.mlp, block.norm2
    with torch.no_grad():
        want = block.mlp_residual(_t(x))
        got = fm.fused_ln_mlp_residual(_t(x), n2.weight, n2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias, block.ls2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_block_forward_is_its_two_halves():
    x, params = _inputs((1, 17, 64), 256, seed=3)
    block = _block(64, params)
    with torch.no_grad():
        torch.testing.assert_close(block(_t(x)), block.mlp_residual(block.attention_residual(_t(x))), rtol=0, atol=0)


def test_cpu_calls_count_no_launch():
    fa.reset_launch_counts()
    x, params = _inputs((1, 5, 64), 64)
    fm.fused_ln_mlp_residual(_t(x), *(_t(p) for p in params))
    assert fm.fused_ln_mlp_residual.launches == 0
    assert fa.launch_counts()["fused_mlp"] == 0


def test_bad_shapes_raise():
    x, params = _inputs((1, 5, 64), 128)
    x, params = _t(x), [_t(p) for p in params]
    for i, bad in ((0, params[0][:63]), (2, params[2][:, :63]), (3, params[3][:127]), (4, params[4].T.contiguous()),
                   (6, params[6][None])):
        args = list(params)
        args[i] = bad
        with pytest.raises(ValueError):
            fm.fused_ln_mlp_residual(x, *args)
    with pytest.raises(ValueError):
        fm.fused_ln_mlp_residual(x[:, :0], *params)


def test_kernel_launcher_refuses_what_it_cannot_take():
    """What the CUDA kernel cannot take raises before any launch: F that is
    no multiple of 64 or above 1024, H no multiple of 32, another dtype,
    mixed dtypes, a token tensor that is not contiguous or 16-byte aligned."""

    def refused(x, params):
        with pytest.raises(ValueError):
            fm._launch(x, params, torch.empty_like(x), 1e-6)

    def case(f, hidden, dtype=torch.bfloat16):
        x, params = _inputs((1, 4, f), hidden)
        return _t(x, dtype), [_t(p, dtype) for p in params]

    refused(*case(96, 384))
    refused(*case(2048, 8192))
    refused(*case(64, 48))
    refused(*case(64, 256, torch.float16))
    x, params = case(64, 256)
    refused(x.float(), params)  # tokens and weights of two dtypes
    refused(torch.cat([x, x], dim=-1)[..., ::2], params)  # tokens not contiguous
    refused(torch.cat([x.flatten(), x.flatten()[:1]])[1:].view_as(x), params)  # tokens 2 bytes off 16-byte alignment


def _slots() -> dict:
    """``enum Slot`` of csrc/fused_mlp.cu: name -> index."""
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

    def mdpt_fused_mlp(self, args_ptr, eps, stream):
        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        rows, f, hidden = a[s["SLOT_ROWS"]], a[s["SLOT_FEATURES"]], a[s["SLOT_HIDDEN"]]
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        shapes = {"SLOT_X": (rows, f), "SLOT_LN_W": (f,), "SLOT_LN_B": (f,), "SLOT_W1": (hidden, f), "SLOT_B1": (hidden,),
                  "SLOT_W2": (f, hidden), "SLOT_B2": (f,), "SLOT_LS": (f,), "SLOT_OUT": (rows, f)}
        t = {k: self._view(a[s[k]], shape, dtype) for k, shape in shapes.items()}
        self.calls.append({"rows": rows, "f": f, "hidden": hidden, "dtype": dtype, "eps": eps})
        params = [t[k] for k in ("SLOT_LN_W", "SLOT_LN_B", "SLOT_W1", "SLOT_B1", "SLOT_W2", "SLOT_B2", "SLOT_LS")]
        t["SLOT_OUT"].copy_(fm.fused_ln_mlp_residual_reference(t["SLOT_X"], *params, eps=eps))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = StubLibrary(_slots())
    recorded = {}

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        recorded["values"] = [0 if x is None else x for x in values]
        return array.array(code, recorded["values"])

    monkeypatch.setattr(fm, "array", types.SimpleNamespace(array=record))
    monkeypatch.setattr(fm, "_device_route", lambda device, name: False)
    monkeypatch.setattr(fm, "kernel_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    lib.recorded = recorded
    return lib


@pytest.mark.parametrize("dtype,shape,hidden", [(torch.float32, (2, 37, 128), 512), (torch.bfloat16, (3, 64), 192),
                                                (torch.bfloat16, (2, 5, 7, 64), 256)])
def test_wrapper_arithmetic_through_stub_library(stub, dtype, shape, hidden):
    """The kernel route's addresses, row count and widths, read back by a
    stub library that runs the plain version: the result equals the plain
    version on the original tensors."""
    x, params = _inputs(shape, hidden, seed=4)
    x, params = _t(x, dtype), [_t(p, dtype) for p in params]
    fm.fused_ln_mlp_residual.launches = 0
    got = fm.fused_ln_mlp_residual(x, *params, eps=1e-5)
    assert fm.fused_ln_mlp_residual.launches == 1 and len(stub.calls) == 1
    assert len(stub.recorded["values"]) == stub.slots["NUM_SLOTS"]
    call = stub.calls[0]
    assert (call["rows"], call["f"], call["hidden"], call["dtype"]) == (x.numel() // shape[-1], shape[-1], hidden, dtype)
    assert call["eps"] == pytest.approx(1e-5)
    want = fm.fused_ln_mlp_residual_reference(x, *params, eps=1e-5)
    assert got.shape == want.shape == x.shape and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
