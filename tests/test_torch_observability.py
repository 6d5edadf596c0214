"""``muggled_dpt_tpu_torch.utils.observability``: the program's spans on
every family's serving path (off by default; on inside ``tracing()``;
``mdpt:`` ranges under ``torch.profiler``; skipped under ``torch.export``),
the aux cache's counters, the memory report and ``assert_finite`` on
tensors and nested containers (the cases of
tests/test_helpers_and_cache.py:97-118 on the port); and the kernels'
refusal to run under autograd (``ops/kernels/flash_attention.py:_refuse_grad``):
every wrapper's CUDA route raises when an operand requires grad with grad
mode on, before it touches the kernel library, and never falls back to the
plain version; under ``no_grad`` / ``inference_mode`` the refusal passes."""

import sys
import threading

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import dpt as dpt_mod
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.experiments.export_model import export_forward
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_int8 as fi8
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_staged as fst
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_xl as fxl
from muggled_dpt_tpu_torch.ops.kernels import fused_mlp as fm
from muggled_dpt_tpu_torch.ops.kernels import head_tail as ht
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa
from muggled_dpt_tpu_torch.tools import attn_variants as fav
from muggled_dpt_tpu_torch.utils import observability
from muggled_dpt_tpu_torch.utils.observability import (
    RANGE_PREFIX,
    assert_finite,
    device_memory_report,
    trace_span,
    tracing,
)

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
FRAMES = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 60, 80, 3), np.uint8))

# name -> (tiny model builder, output size, blocks)
FAMILIES = {
    "da_v2": (lambda: make_depthanythingv2_dpt(64, 2, 4, (8, 16, 32, 64), (8, 8), 16, device=DEVICE), (112, 112), 4),
    "beit": (lambda: make_beit_dpt(128, 2, 4, (16, 24, 32, 40), (6, 6), 16, device=DEVICE), (96, 96), 4),
    "swinv2": (lambda: make_swinv2_dpt((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16,
                                       device=DEVICE), (128, 128), 8),
}
SWIN_BLOCK_SPANS = ["window", "cosine", "attention", "window", "mlp"]
# name -> the encoder span's children in order: a ViT block opens attention then mlp; SwinV2's stages of
# 2 blocks each open a merge span between them
ENCODER_CHILDREN = {
    "da_v2": ["attention", "mlp"] * 4,
    "beit": ["attention", "mlp"] * 4,
    "swinv2": (SWIN_BLOCK_SPANS * 2 + ["merge"]) * 3 + SWIN_BLOCK_SPANS * 2,
}


def test_step_timer_and_memory_report():
    """The memory report is a dict ({} without a card), and a span outside
    ``tracing()`` is the shared null context."""
    report = device_memory_report()
    assert isinstance(report, dict)
    if not torch.cuda.is_available():
        assert report == {}  # JAX: `stats or {}` per device; the CPU has no allocator stats here
    with trace_span("test-span"):
        pass


def children(spans, parent) -> list:
    return [s.name for s in spans if s.parent == parent]


def check_request(spans, root: int, encoder_children: list, built: bool):
    """The spans of one facade call, rooted at ``spans[root]``: the facade's
    children in order, the encoder's children in order, one request id,
    every span closed and inside its parent."""
    facade = spans[root]
    assert facade.name == "facade" and facade.parent is None
    aux = [i for i, s in enumerate(spans) if s.parent == root and s.name == "facade.aux"]
    encoder = [i for i, s in enumerate(spans) if s.parent == root and s.name == "encoder"]
    assert children(spans, root) == ["facade.prep", "facade.aux", "encoder", "neck"]
    assert children(spans, aux[0]) == (["facade.aux_build"] if built else [])
    assert children(spans, encoder[0]) == encoder_children
    held = {root}
    for i, s in enumerate(spans):
        if s.parent in held:
            held.add(i)
    for i in held:
        s = spans[i]
        assert s.request == facade.request and 0 < s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    return held


def test_spans_off_record_nothing():
    """Outside ``tracing()`` a forward records nothing: every span is one
    shared object, and a list from an ended context stays as it was."""
    model = FAMILIES["da_v2"][0]()
    with tracing() as spans:
        pass
    assert observability._recorder is None
    assert trace_span("a") is trace_span("b", request=True) is observability._NULL
    model.inference_rgb_device(FRAMES, (112, 112))
    assert spans == []


@pytest.mark.parametrize("family", list(FAMILIES))
def test_spans_nest_on_the_serving_path(family):
    """Two ``inference_rgb_device`` calls: each a ``facade`` span over prep,
    the aux lookup (a build on the first call where the family caches one),
    the encoder (an ``attention`` then an ``mlp`` span per block; SwinV2's
    ``window``, ``cosine`` and ``merge`` spans besides) and the neck;
    parents right, one request id per call, children inside their parents,
    and no span left over."""
    make, size, blocks = FAMILIES[family]
    model = make()
    cached = model.spec.get("make_aux") is not None
    with tracing() as spans:
        model.inference_rgb_device(FRAMES, size)
        second = len(spans)
        model.inference_rgb_device(FRAMES[:1], size)
    first = check_request(spans, 0, ENCODER_CHILDREN[family], built=cached)
    again = check_request(spans, second, ENCODER_CHILDREN[family], built=False)
    assert first | again == set(range(len(spans)))
    assert (spans[0].request, spans[second].request) == (0, 1)
    assert sum(s.name == "attention" for s in spans) == 2 * blocks


def test_profiler_ranges_nest_like_the_spans():
    """Under a CPU ``torch.profiler`` session each span is also an
    ``mdpt:<name>`` range, nested as the spans are; with tracing off the
    profile holds no such range."""
    make, size, blocks = FAMILIES["beit"]
    model = make()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.inference_rgb_device(FRAMES, size)
        with tracing() as spans:
            model.inference_rgb_device(FRAMES, size)
    ranges = sorted((e.time_range.start, -e.time_range.end, e.name[len(RANGE_PREFIX):])
                    for e in prof.events() if e.name.startswith(RANGE_PREFIX))
    assert [name for _, _, name in ranges] == [s.name for s in spans]
    for span, (start, neg_end, _) in zip(spans, ranges):
        if span.parent is not None:
            p_start, p_neg_end, _ = ranges[span.parent]
            assert p_start <= start and -neg_end <= -p_neg_end
    assert sum(s.name == "mlp" for s in spans) == blocks


def test_export_is_the_same_with_tracing_on():
    """``torch.export`` of the kernel forward gives the same graph with
    tracing on, and records no span while it traces."""
    model = FAMILIES["beit"][0]()
    off = export_forward(model, (96, 96)).graph_module.print_readable(print_output=False)
    with tracing() as spans:
        on = export_forward(model, (96, 96)).graph_module.print_readable(print_output=False)
    assert on == off and spans == []


def test_aux_counters(monkeypatch):
    """BEiT's aux cache over two grids, a forced eviction and a grid that
    never fits: each lookup is a hit, a build or a never-fit, and each grid
    dropped to make room an eviction."""
    model = FAMILIES["beit"][0]()
    assert model.aux_stats == {"hits": 0, "builds": 0, "evictions": 0, "never_fit": 0}
    model.inference_rgb_device(FRAMES, (96, 96))
    model.inference_rgb_device(FRAMES, (96, 96))
    model.inference_rgb_device(FRAMES, (128, 128))
    assert model.aux_stats == {"hits": 1, "builds": 2, "evictions": 0, "never_fit": 0}
    # room for one grid: a third grid evicts the least recently used
    cache_values = type({}.values())
    monkeypatch.setattr(dpt_mod, "_tensor_bytes",
                        lambda ts: sum(t is not None for t in ts) if isinstance(ts, cache_values) else 0)
    monkeypatch.setattr(dpt_mod, "fits_device_budget",
                        lambda needed, device, resident_bytes=0, reclaimable_bytes=0: resident_bytes - reclaimable_bytes < 1)
    model.inference_rgb_device(FRAMES, (64, 64))
    assert model.aux_stats == {"hits": 1, "builds": 3, "evictions": 2, "never_fit": 0}
    monkeypatch.setattr(dpt_mod, "fits_device_budget", lambda needed, device, resident_bytes=0, reclaimable_bytes=0: False)
    model.inference_rgb_device(FRAMES, (160, 160))
    model.inference_rgb_device(FRAMES, (160, 160))
    model.inference_rgb_device(FRAMES, (64, 64))
    assert model.aux_stats == {"hits": 2, "builds": 3, "evictions": 2, "never_fit": 2}


def test_spans_from_threads_keep_their_parents():
    """Threads opening nested spans at once into one ``tracing()`` list:
    every span's parent is its own thread's outer span, every span closes."""
    threads, rounds = 8, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing() as spans:
            def work(k):
                for _ in range(rounds):
                    with trace_span(f"outer.{k}", request=True):
                        with trace_span(f"inner.{k}"):
                            pass

            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert len(spans) == 2 * threads * rounds
    assert len({s.request for s in spans}) == threads * rounds
    for s in spans:
        assert s.t1_ns >= s.t0_ns > 0
        if s.name.startswith("inner."):
            parent = spans[s.parent]
            assert parent.name == "outer." + s.name.split(".")[1] and parent.request == s.request
        else:
            assert s.parent is None


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

    def no_library(*entry):
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(_build, "kernel_entry", no_library)
    args = make()
    if grad is None:
        args = args.clone().requires_grad_()
    else:
        args = tuple(a.clone().requires_grad_() if i == grad else a for i, a in enumerate(args))
    entry = name.split()[0]
    with pytest.raises(RuntimeError, match=f"^{entry}: an operand requires grad"):
        call(args)
