"""``muggled_dpt_tpu_torch.utils.observability`` (the cases of
tests/test_helpers_and_cache.py:97-118 on the port, plus the profiler trace
and ``assert_finite`` on tensors and nested containers) and the kernels'
refusal to run under autograd (``ops/kernels/flash_attention.py:_refuse_grad``):
every wrapper's CUDA route raises when an operand requires grad with grad
mode on, before it touches the kernel library, and never falls back to the
plain version; under ``no_grad`` / ``inference_mode`` the refusal passes."""

import json
import os
import time

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_int8 as fi8
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_staged as fst
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_xl as fxl
from muggled_dpt_tpu_torch.ops.kernels import fused_mlp as fm
from muggled_dpt_tpu_torch.ops.kernels import head_tail as ht
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa
from muggled_dpt_tpu_torch.tools import attn_variants as fav
from muggled_dpt_tpu_torch.utils.observability import (
    StepTimer,
    assert_finite,
    device_memory_report,
    start_profiler_trace,
    stop_profiler_trace,
    trace_span,
)


def test_step_timer_and_memory_report():
    t = StepTimer(smoothing=0.0)
    t.tick()
    time.sleep(0.01)
    t.tick()
    assert t.ms > 5 and t.fps > 0
    report = device_memory_report()
    assert isinstance(report, dict)
    if not torch.cuda.is_available():
        assert report == {}  # JAX: `stats or {}` per device; the CPU has no allocator stats here
    with trace_span("test-span", log=True):
        pass


def test_assert_finite_guard():
    assert_finite({"a": np.ones(3)}, "ok")
    with pytest.raises(FloatingPointError, match="bad/a"):
        assert_finite({"a": np.array([1.0, np.inf])}, "bad")


def test_assert_finite_tensors_and_nesting():
    ok = {"x": torch.ones(2), "y": [torch.zeros(3, dtype=torch.bfloat16), {"z": np.arange(3)}], "n": torch.arange(4)}
    assert assert_finite(ok, "fine") is ok
    with pytest.raises(FloatingPointError, match=r"^loss: 1 non-finite values$"):
        assert_finite(torch.tensor([1.0, float("nan")]), "loss")
    with pytest.raises(FloatingPointError, match=r"^grads/y/1/z: 2 non-finite values$"):
        assert_finite({"y": [torch.ones(1), {"z": torch.tensor([np.inf, -np.inf], dtype=torch.bfloat16)}]}, "grads")


def test_profiler_trace_exports_chrome_json(tmp_path):
    folder = start_profiler_trace(str(tmp_path / "trace"))
    with trace_span("traced-region"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = stop_profiler_trace()
    assert path == os.path.join(folder, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "traced-region" for e in events)
    with pytest.raises(RuntimeError, match="no profiler trace"):
        stop_profiler_trace()


def test_refuse_grad_passes_without_autograd():
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        fa._refuse_grad("k", x)
    with torch.inference_mode():
        fa._refuse_grad("k", x)
    fa._refuse_grad("k", torch.ones(3), None, (1, 2))  # grad mode on, nothing requires grad
    with pytest.raises(RuntimeError, match="k: an operand requires grad.*no backward kernel"):
        fa._refuse_grad("k", None, torch.ones(3), x)


def _g(*shape, dtype=torch.float32):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0)).to(dtype)


def _qkv():
    return _g(1, 8, 3 * 2 * 64)


def _mlp():
    return (_g(4, 64), _g(64), _g(64), _g(256, 64), _g(256), _g(64, 256), _g(64), _g(64))


def _head():
    return (_g(1, 8, 6, 6), _g(ht.OUT_CHANNELS, 8, 3, 3), _g(ht.OUT_CHANNELS), _g(1, ht.OUT_CHANNELS, 1, 1), _g(1))


def _window():
    return (_g(1, 1, 16, 2, 32), _g(1, 1, 16, 2, 32), _g(1, 1, 16, 2, 32), _g(2, 16, 16), _g(1, 16, 16))


# name -> (its module, the operands, the call, the operand that requires grad: None for a lone tensor)
WRAPPERS = {
    "flash_attention_fused_qkv": (fa, _qkv, lambda a: fa.flash_attention_fused_qkv(a, 2), None),
    "flash_attention_fused_qkv biased": (fa, lambda: (_qkv(), _g(1, 2, 8, 8)),
                                         lambda a: fa.flash_attention_fused_qkv(a[0], 2, bias=a[1]), 1),
    "flash_attention": (fa, lambda: (_g(1, 8, 2, 64),) * 3, lambda a: fa.flash_attention(*a), 2),
    "window_attention": (wa, _window, lambda a: wa.window_attention(*a), 3),
    "fused_ln_mlp_residual": (fm, _mlp, lambda a: fm.fused_ln_mlp_residual(*a), 3),
    "fused_head_tail": (ht, _head, lambda a: ht.fused_head_tail(*a), 1),
    "flash_attention_int8_qk": (fi8, lambda: (_g(2, 8, 64),) * 3, lambda a: fi8.flash_attention_int8_qk(*a), 0),
    "flash_attention_int8_qk_fused": (fi8, _qkv, lambda a: fi8.flash_attention_int8_qk_fused(a, 2), None),
    "flash_attention_fused_qkv_xl": (fxl, _qkv, lambda a: fxl.flash_attention_fused_qkv_xl(a, 2), None),
    "flash_attention_fused_qkv_staged": (fst, _qkv, lambda a: fst.flash_attention_fused_qkv_staged(a, 2), None),
    "flash_variant": (fav, lambda: (_g(2, 8, 64),) * 3, lambda a: fav.flash_variant(*a), 1),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cuda_route_refuses_autograd(name, monkeypatch):
    """The wrapper taken down its CUDA route (``_device_route`` False) with
    an operand that requires grad: it raises naming itself, and neither the
    kernel library nor the plain version is reached."""
    module, make, call, grad = WRAPPERS[name]
    monkeypatch.setattr(module, "_device_route", lambda device, what: False)

    def no_library():
        raise AssertionError("the kernel library was reached")

    for mod in (_build, fa, wa, fm, ht, fi8, fxl, fst, fav):
        if hasattr(mod, "kernel_library"):
            monkeypatch.setattr(mod, "kernel_library", no_library)
    args = make()
    if grad is None:
        args = args.clone().requires_grad_()
    else:
        args = tuple(a.clone().requires_grad_() if i == grad else a for i, a in enumerate(args))
    entry = name.split()[0]
    with pytest.raises(RuntimeError, match=f"^{entry}: an operand requires grad"):
        call(args)
