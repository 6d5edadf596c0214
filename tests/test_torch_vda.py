"""Video Depth Anything in the port (``models/video_depth_anything.py``,
``models/temporal.py``, ``checkpoints/video_depth_anything.py``) against the
plain float32 reference of the benchmark (``port_bench/reference/
video_depth_anything.py``), on the CPU at a tiny width: F=128 (2 heads x 64),
4 blocks, neck 32 / [32, 64, 64, 64], temporal modules at C = 64, 64, 32, 32
(32 groups and 8 heads divide each), on a non-square 6 x 10 patch grid.

The JAX package has no such model; the reference is what the port is held
to, within the repo's f32 abs-rel budget (README "Numerical parity"). Also:
the time axis is read (a changed frame moves the others; a permuted clip is
not a permuted depth, the position encoding), a clip longer than
``num_frames`` raises, the converter loads the original layout strictly and
sniffs the type, the spans, and where the benchmark's own hooks
(``port_bench/trace.py:layer_spans``) see each temporal module and each
moved fuse conv."""

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import make_dpt_from_state_dict
from muggled_dpt_tpu_torch.checkpoints import video_depth_anything as conv
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_video_depth_anything_state_dict
from muggled_dpt_tpu_torch.make_dpt import determine_model_type_from_state_dict
from muggled_dpt_tpu_torch.utils.observability import RANGE_PREFIX, tracing
from port_bench import trace
from port_bench.reference import no_tf32
from port_bench.reference import video_depth_anything as reference

ABS_REL_BUDGET = 1e-3  # the repo's f32 parity budget; port and reference differ in summation order only
CFG = {
    "features_per_token": 128,
    "num_blocks": 4,
    "num_heads": 2,
    "reassembly_features_list": [32, 64, 64, 64],
    "fusion_channels": 32,
    "patch_size_px": 14,
    "base_patch_grid_hw": (4, 4),
    "temporal_channels": [64, 64, 32, 32],
}
SIZE = (84, 140)  # a 6 x 10 patch grid
SEED = 11


def _abs_rel(ours, ref) -> float:
    return float((ours - ref).abs().mean() / (ref.abs().mean() + 1e-12))


def _frames(count, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (count, 60, 100, 3), np.uint8))


@pytest.fixture(scope="module")
def original():
    sd = random_original_video_depth_anything_state_dict(CFG, SEED)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def checkpoint(original, tmp_path_factory):
    path = tmp_path_factory.mktemp("vda") / "video_depth_anything_vits_tiny.pth"
    torch.save(original, str(path))
    return str(path)


@pytest.fixture(scope="module")
def model(checkpoint):
    return make_dpt_from_state_dict(checkpoint, device="cpu")


def _reference(original, config, frames):
    with no_tf32():
        return reference.forward(original, config, frames, SIZE)


def test_the_converter_detects_and_loads_the_original_layout(original, model):
    """The type is sniffed from ``head.motion_modules.`` keys; the config reads
    the widths, the published-or-quarter taps, four modules of two attention
    blocks; the net was loaded strictly (``assemble_model``); a checkpoint
    without the ``pe`` buffers converts to the same tensors."""
    assert determine_model_type_from_state_dict("model.pth", original) == "videodepthanything"
    config, _ = model
    assert config["encoder_taps"] == [0, 1, 2, 3] and config["temporal_channels"] == [64, 64, 32, 32]
    assert (config["temporal_heads"], config["temporal_attention_blocks"], config["num_frames"]) == (8, 2, 32)
    net = model[1].net
    assert len(net.temporal) == 4 and [s.fuse is None for s in net.reassemble] == [False, False, True, True]
    assert [b.fuse is None for b in net.fusion] == [True, True, False, False]
    no_pe = {k: v for k, v in original.items() if not k.endswith(".pe")}
    with_pe, without = conv.convert_state_dict(original, config), conv.convert_state_dict(no_pe, config)
    assert with_pe.keys() == without.keys()
    assert all(torch.equal(with_pe[k], without[k]) for k in with_pe)
    assert conv.get_config_from_state_dict(no_pe)["num_frames"] == 32


def test_published_taps():
    assert conv.published_taps(24) == (4, 11, 17, 23) and conv.published_taps(12) == (2, 5, 8, 11)


@pytest.mark.parametrize("frames", [4, 5])
def test_depth_matches_the_reference(original, model, frames):
    config, m = model
    x = _frames(frames)
    got = m.inference_rgb_device(x, SIZE)
    ref = _reference(original, config, x)
    assert got.shape == ref.shape == (frames, *SIZE)
    assert float(ref.std()) > 0.01 * float(ref.abs().mean())  # the depth has structure, not an offset
    assert _abs_rel(got, ref) <= ABS_REL_BUDGET


@pytest.mark.parametrize("i", range(4))
def test_each_temporal_module_matches_the_reference(original, model, i):
    c = CFG["temporal_channels"][i]
    x = torch.randn(5, c, 3, 7, generator=torch.Generator().manual_seed(i))
    with torch.inference_mode():
        got = model[1].net.temporal[i](x, 5)
    with no_tf32():
        ref = reference.temporal_module(x, original, f"head.motion_modules.{i}", 5)
    assert _abs_rel(got, ref) <= ABS_REL_BUDGET
    assert _abs_rel(got, x) > 0.05  # the module adds to its map


def test_the_time_axis_is_read(model):
    """One frame changed moves every other frame's depth; a permuted clip
    does not give the permuted depth (the position encoding of the frame
    index), where frames computed one by one would."""
    m = model[1]
    x = _frames(5)
    base = m.inference_rgb_device(x, SIZE)
    changed = x.clone()
    changed[0] = _frames(1, seed=9)[0]
    moved = m.inference_rgb_device(changed, SIZE)
    scale = float(base.abs().mean())
    for t in range(1, 5):
        assert float((moved[t] - base[t]).abs().max()) > 1e-4 * scale
    perm = torch.tensor([3, 0, 4, 1, 2])
    permuted = m.inference_rgb_device(x[perm], SIZE)
    assert float((permuted - base[perm]).abs().max()) > 1e-4 * scale


def test_a_clip_longer_than_num_frames_raises(model):
    with pytest.raises(ValueError, match="at most 32 frames"):
        model[1].inference_rgb_device(_frames(33), SIZE)


def test_spans_and_tracing_changes_no_bit(model):
    """Four ``temporal`` spans in the ``neck``, each holding two
    ``temporal.attention`` spans; the depth is the same with tracing on."""
    m = model[1]
    x = _frames(4)
    off = m.inference_rgb_device(x, SIZE)
    with tracing() as spans:
        on = m.inference_rgb_device(x, SIZE)
    assert torch.equal(on, off)
    (neck,) = [i for i, s in enumerate(spans) if s.name == "neck"]
    temporal = [i for i, s in enumerate(spans) if s.name == "temporal"]
    assert len(temporal) == 4 and all(spans[i].parent == neck for i in temporal)
    attention = [s for s in spans if s.name == "temporal.attention"]
    assert len(attention) == 8 and all(spans[s.parent].name == "temporal" for s in attention)
    assert sorted(sum(s.parent == i for s in attention) for i in temporal) == [2, 2, 2, 2]


def _ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]


def _inside(iv, ranges):
    return any(s <= iv[0] and iv[1] <= e for s, e in ranges)


def _overlaps(iv, ranges):
    return any(iv[0] < e and s < iv[1] for s, e in ranges)


def test_the_benchmark_sees_the_temporal_modules_in_the_neck_alone(model):
    """Under the harness's hooks (``trace.layer_spans``) and a CPU profiler:
    each ``mdpt:temporal`` range and every GroupNorm lies inside ``pb:neck``
    and overlaps no ``pb:reassemble.*``, ``pb:fusion.*`` or ``pb:head``
    range; the fuse convs of taps 3 and 4 (the 64 -> 32 3x3 convs at the
    grid and at half of it) run inside ``pb:fusion.2`` and ``pb:fusion.3``."""
    from torch.profiler import ProfilerActivity, profile

    m = model[1]
    with trace.layer_spans(m.net), tracing(), profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        m.inference_rgb_device(_frames(4), SIZE)
    events = prof.events()
    neck = _ranges(events, trace.PREFIX + "neck")
    hooked = [r for name in ["reassemble.0", "reassemble.1", "reassemble.2", "reassemble.3", "fusion.0", "fusion.1",
                             "fusion.2", "fusion.3", "head"] for r in _ranges(events, trace.PREFIX + name)]
    assert len(neck) == 1 and len(hooked) == 9
    temporal = _ranges(events, RANGE_PREFIX + "temporal")
    norms = _ranges(events, "aten::group_norm")
    assert len(temporal) == 4 and len(norms) == 4
    for iv in temporal + norms:
        assert _inside(iv, neck) and not _overlaps(iv, hooked)
    fuse = {}
    for e in events:
        if e.name == "aten::conv2d" and e.input_shapes and e.input_shapes[1] == [32, 64, 3, 3]:
            fuse[tuple(e.input_shapes[0][2:])] = (e.time_range.start, e.time_range.end)
    assert _inside(fuse[(6, 10)], _ranges(events, trace.PREFIX + "fusion.2"))
    assert _inside(fuse[(3, 5)], _ranges(events, trace.PREFIX + "fusion.3"))
