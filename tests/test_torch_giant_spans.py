"""ViT-Giant's ``gate`` span (``ops/nn.py:mlp_swiglu``): each SwiGLU block
opens one ``gate`` span around silu(a) * b, inside that block's ``mlp``
span under ``encoder``; a GELU block opens none; under ``torch.profiler``
each is an ``mdpt:gate`` range; and tracing changes no bit of the depth.
Also the Giant's taps: ``stage_taps(40)`` is the published
``intermediate_layer_idx['vitg']`` of Depth-Anything V2's ``dpt.py``."""

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import make_depthanythingv2_dpt
from muggled_dpt_tpu_torch.models.dinov2 import stage_taps
from muggled_dpt_tpu_torch.utils.observability import RANGE_PREFIX, tracing

SIZE = (112, 112)
BLOCKS = 4
FRAMES = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 60, 80, 3), np.uint8))


def make(is_giant=True, enable_optimizations=True):
    return make_depthanythingv2_dpt(64, 2, BLOCKS, (8, 16, 32, 64), (8, 8), 16, is_giant=is_giant,
                                    enable_optimizations=enable_optimizations, device="cpu")


def test_giant_taps_are_the_published_ones():
    assert stage_taps(40) == (9, 19, 29, 39)


@pytest.mark.parametrize("enable_optimizations", [True, False], ids=["kernel", "plain"])
def test_one_gate_span_per_block_inside_its_mlp(enable_optimizations):
    """One traced forward: every ``mlp`` span under the encoder holds exactly
    one child, a ``gate`` span inside it, and there is no other ``gate``."""
    with tracing() as spans:
        make(enable_optimizations=enable_optimizations).inference_rgb_device(FRAMES, SIZE)
    (encoder,) = [i for i, s in enumerate(spans) if s.name == "encoder"]
    mlps = [i for i, s in enumerate(spans) if s.name == "mlp"]
    gates = [s for s in spans if s.name == "gate"]
    assert len(mlps) == len(gates) == BLOCKS
    for i in mlps:
        assert spans[i].parent == encoder
        (gate,) = [s for s in spans if s.parent == i]
        assert gate.name == "gate" and spans[i].t0_ns <= gate.t0_ns <= gate.t1_ns <= spans[i].t1_ns
    assert all(spans[g.parent].name == "mlp" for g in gates)


def test_a_gelu_block_opens_no_gate_span():
    with tracing() as spans:
        make(is_giant=False).inference_rgb_device(FRAMES, SIZE)
    assert sum(s.name == "mlp" for s in spans) == BLOCKS
    assert not any(s.name == "gate" for s in spans)


def test_capture_opens_the_gate_spans():
    """``forward_with_internals`` runs each block's MLP half through the same span."""
    with tracing() as spans:
        make().forward_with_internals(torch.randn(1, 3, *SIZE))
    assert sum(s.name == "gate" for s in spans) == BLOCKS


def test_depth_is_the_same_with_tracing_on():
    model = make()
    off = model.inference_rgb_device(FRAMES, SIZE)
    with tracing() as spans:
        on = model.inference_rgb_device(FRAMES, SIZE)
    assert any(s.name == "gate" for s in spans) and torch.equal(on, off)


def test_profiler_ranges_of_the_gate_span():
    """Under a CPU ``torch.profiler`` session each ``gate`` span is an
    ``mdpt:gate`` range; with tracing off there is none."""
    model = make()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.inference_rgb_device(FRAMES, SIZE)
        with tracing():
            model.inference_rgb_device(FRAMES, SIZE)
    ranges = [e.name[len(RANGE_PREFIX):] for e in prof.events() if e.name.startswith(RANGE_PREFIX)]
    assert ranges.count("gate") == BLOCKS
