"""SwinV2's own spans (``models/swinv2.py``): each block opens two ``window``
spans (the roll and partition before qkv, the merge and roll back after
proj), one ``cosine`` span (the float32 normalize of q and k up to the
attention call) and one ``attention`` span, each patch merge a ``merge``
span, all directly under ``encoder``; under ``torch.profiler`` each is an
``mdpt:<name>`` range; and tracing changes no bit of the depth.

A tiny SwinV2 at 96x96 with window 4: its stage grids 24, 12, 6 and 3 shift
at 24 and 12, fit one 6x6 window at 6 and clip to 3 at 3, the pattern of
SwinV2-L-384's 96, 48, 24 and 12 with window 24."""

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import make_swinv2_dpt
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
