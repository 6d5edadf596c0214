"""SwinV2's own spans (``models/swinv2.py``): each block opens two ``window``
spans (the roll and partition before qkv, the merge and roll back after
proj), one ``cosine`` span (the normalize of q and k up to the attention
call: one ``cosine_qk`` call on the kernel path, the float32 composite on
the plain path and in ``forward_with_internals``) and one ``attention``
span, each patch merge a ``merge`` span, all directly under ``encoder``;
under ``torch.profiler`` each is an ``mdpt:<name>`` range; and tracing
changes no bit of the depth.

A tiny SwinV2 at 96x96 with window 4: its stage grids 24, 12, 6 and 3 shift
at 24 and 12, fit one 6x6 window at 6 and clip to 3 at 3, the pattern of
SwinV2-L-384's 96, 48, 24 and 12 with window 24."""

import time

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import make_swinv2_dpt
from muggled_dpt_tpu_torch.models import swinv2
from muggled_dpt_tpu_torch.models.swinv2 import stage_grids, window_plan
from muggled_dpt_tpu_torch.utils.observability import RANGE_PREFIX, tracing

SIZE = (96, 96)
LAYERS = (2, 2, 2, 2)
BLOCKS = sum(LAYERS)
BLOCK_SPANS = ["window", "cosine", "attention", "window", "mlp"]
FRAMES = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 60, 100, 3), np.uint8))


def make(enable_optimizations=True, enable_cache=True):
    return make_swinv2_dpt((16, 32, 64, 128), (2, 4, 4, 8), LAYERS, (16, 16), (4, 4), (None,) * 4, 16,
                           enable_cache=enable_cache, enable_optimizations=enable_optimizations, device="cpu")


def test_the_tiny_grid_shifts_where_the_large_one_does():
    shifts = [window_plan(g, (4, 4))[1] != (0, 0) for g in stage_grids((SIZE[0] // 4, SIZE[1] // 4))]
    assert shifts == [True, True, False, False]
    assert [window_plan(g, (24, 24))[1] != (0, 0) for g in stage_grids((96, 96))] == shifts


@pytest.mark.parametrize("enable_cache", [True, False], ids=["cached", "inline"])
@pytest.mark.parametrize("enable_optimizations", [True, False], ids=["kernel", "plain"])
def test_block_spans_under_the_encoder(enable_optimizations, enable_cache):
    """One traced forward: per block window, cosine, attention, window, mlp
    in that order, a merge between stages, every one a child of the
    encoder span and inside it."""
    model = make(enable_optimizations, enable_cache)
    with tracing() as spans:
        model.inference_rgb_device(FRAMES, SIZE)
    encoders = [i for i, s in enumerate(spans) if s.name == "encoder"]
    assert len(encoders) == 1
    enc = spans[encoders[0]]
    under = [s for s in spans if s.parent == encoders[0]]
    stage = BLOCK_SPANS * 2
    assert [s.name for s in under] == stage + ["merge"] + stage + ["merge"] + stage + ["merge"] + stage
    counts = {n: sum(s.name == n for s in spans) for n in ("window", "cosine", "attention", "mlp", "merge")}
    assert counts == {"window": 2 * BLOCKS, "cosine": BLOCKS, "attention": BLOCKS, "mlp": BLOCKS, "merge": 3}
    for s in under:
        assert enc.t0_ns <= s.t0_ns <= s.t1_ns <= enc.t1_ns
    for a, b in zip(under, under[1:]):
        assert a.t1_ns <= b.t0_ns  # siblings, one after the other


@pytest.mark.parametrize("enable_optimizations", [True, False], ids=["kernel", "plain"])
def test_depth_is_the_same_with_tracing_on(enable_optimizations):
    model = make(enable_optimizations)
    off = model.inference_rgb_device(FRAMES, SIZE)
    with tracing() as spans:
        on = model.inference_rgb_device(FRAMES, SIZE)
    assert spans and torch.equal(on, off)


def test_profiler_ranges_of_the_swinv2_spans():
    """Under a CPU ``torch.profiler`` session each new span is an ``mdpt:``
    range, as many as the spans; with tracing off there is none."""
    model = make()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.inference_rgb_device(FRAMES, SIZE)
        with tracing() as spans:
            model.inference_rgb_device(FRAMES, SIZE)
    ranges = [e.name[len(RANGE_PREFIX):] for e in prof.events() if e.name.startswith(RANGE_PREFIX)]
    for name, n in (("window", 2 * BLOCKS), ("cosine", BLOCKS), ("merge", 3)):
        assert ranges.count(name) == sum(s.name == name for s in spans) == n


def test_capture_opens_the_block_spans():
    """``forward_with_internals`` runs the plain attention path of every
    block, through the same spans."""
    model = make()
    x = torch.randn(1, 3, *SIZE)
    with tracing() as spans:
        model.forward_with_internals(x)
    names = [s.name for s in spans]
    assert (names.count("window"), names.count("cosine"), names.count("attention"), names.count("merge")) == (
        2 * BLOCKS, BLOCKS, BLOCKS, 3)


@pytest.fixture()
def normalize_calls(monkeypatch):
    """The block's two normalize routes, wrapped: the host clock of each
    ``cosine_qk`` call and the number of ``cosine_normalize`` calls."""
    calls = {"cosine_qk": [], "cosine_normalize": 0}
    kernel, composite = swinv2.cosine_qk, swinv2.cosine_normalize

    def cosine_qk(q, k, logit_scale):
        calls["cosine_qk"].append(time.perf_counter_ns())
        return kernel(q, k, logit_scale)

    def cosine_normalize(x):
        calls["cosine_normalize"] += 1
        return composite(x)

    monkeypatch.setattr(swinv2, "cosine_qk", cosine_qk)
    monkeypatch.setattr(swinv2, "cosine_normalize", cosine_normalize)
    return calls


@pytest.mark.parametrize("enable_cache", [True, False], ids=["cached", "inline"])
def test_cosine_span_holds_one_cosine_qk_call_per_block(normalize_calls, enable_cache):
    """On the kernel path each block's ``cosine`` span opens once, around
    its one ``cosine_qk`` call; the composite never runs."""
    model = make(enable_cache=enable_cache)
    with tracing() as spans:
        model.inference_rgb_device(FRAMES, SIZE)
    cosine = [s for s in spans if s.name == "cosine"]
    assert len(cosine) == len(normalize_calls["cosine_qk"]) == BLOCKS
    assert all(s.t0_ns <= t <= s.t1_ns for s, t in zip(cosine, normalize_calls["cosine_qk"]))
    assert normalize_calls["cosine_normalize"] == 0


@pytest.mark.parametrize("path", ["use_kernel_off", "forward_capture"])
def test_plain_path_and_capture_take_the_composite(normalize_calls, path):
    """``use_kernel=False`` (``enable_optimizations=False``) and
    ``forward_with_internals`` (``forward_capture``) normalize q and k with
    the float32 composite, twice a block, inside the ``cosine`` span, and
    never call ``cosine_qk``."""
    with tracing() as spans:
        if path == "use_kernel_off":
            make(enable_optimizations=False).inference_rgb_device(FRAMES, SIZE)
        else:
            make().forward_with_internals(torch.randn(1, 3, *SIZE))
    assert sum(s.name == "cosine" for s in spans) == BLOCKS
    assert normalize_calls == {"cosine_qk": [], "cosine_normalize": 2 * BLOCKS}
