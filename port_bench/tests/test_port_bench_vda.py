"""The Video Depth Anything family (``video_depth_anything``): its weights as
the port's converter reads them, its counts by hand at the cell's 532x924,
the reference's chunked temporal attention, the two temporal metric readers
on a synthetic trace, the cell's sizing, and whole runs of a tiny VDA on the
CPU (sound and faulted) through ``cell.run``.

The tiny VDA is ``tiny_dav2``'s configuration with the family, the published
taps of its depth and four temporal modules at C = 64, 64, 32, 32, built
here: the test data's files stay as they are."""

import importlib
import time
from types import SimpleNamespace

import pytest
import torch

from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_video_depth_anything_state_dict
from muggled_dpt_tpu_torch.dpt import DPTModel

from port_bench import calibrate, check, frames, program, spec, trace
from port_bench import cell as cell_run
from port_bench.reference import exact, no_tf32

FAMILY = "video_depth_anything"
WORKLOAD = "vda_vitl.clip32_924"
SOUND = DPTModel.inference_rgb_device


def full_config():
    return spec.load_json(spec.BENCH_DIR / "configs" / "vda_vitl.json")


def tiny_config(base: dict) -> dict:
    full = full_config()
    keys = ("family", "model_type", "converter", "num_frames", "temporal_heads", "temporal_attention_blocks",
            "temporal_ff_mult")
    return dict(base, name="tiny_vda", encoder_taps=[0, 1, 2, 3], temporal_channels=[64, 64, 32, 32],
                **{k: full[k] for k in keys})


@pytest.fixture
def tiny_vda(tiny_cell):
    base = tiny_cell("tiny_dav2.tiny_b2")
    traffic = dict(base.traffic, batch=4, pool_frames=8, square=False, max_side=112)
    return spec.Cell(dict(base.workload, name="tiny_vda.tiny_clip4", config="tiny_vda"), tiny_config(base.config),
                     traffic, base.limits)


def test_reference_matches_port_in_float32(tiny_vda):
    config = dict(tiny_vda.config, dtype="float32")
    sd = spec.family_module("weights", FAMILY).generate(config, 2**31 + 7, "cpu", torch.float32)
    model = program.build(config, sd, "cpu")
    assert program.port_config_matches(model, config) == []
    traffic = tiny_vda.traffic
    size = frames.scaled_hw(config, traffic)
    assert size == (56, 112)
    x = frames.make_pool(traffic, 5, "cpu")[frames.step_frames(traffic, 1)]
    got = model.inference_rgb_device(x, size)
    with no_tf32():
        ref = spec.family_module("reference", FAMILY).forward(sd, config, x, size)
    errors = check.frame_errors(got, ref)
    assert max(errors) < 2e-5, errors
    assert ref.shape == (traffic["batch"], *size) and float(ref.abs().mean()) > 0.1


def test_chunked_temporal_attention_is_the_unchunked():
    """Every position attends on its own: 7 positions a step give the same
    values as all 50 at once, in float32 and under the bfloat16 rounding."""
    from port_bench.reference import bf16
    from port_bench.reference.video_depth_anything import temporal_attention

    g = torch.Generator().manual_seed(3)
    z = torch.randn(50, 6, 64, generator=g)
    wq, wk, wv = (torch.randn(64, 64, generator=g) / 8 for _ in range(3))
    for q in (bf16, exact):
        whole = temporal_attention(z, wq, wk, wv, q)
        assert torch.equal(temporal_attention(z, wq, wk, wv, q, chunk=7), whole)
    # and in float32 they meet the plain formula
    d = 8
    qs, k, v = ((z @ w.T).reshape(50, 6, 8, d).transpose(1, 2) for w in (wq, wk, wv))
    plain = torch.softmax(qs @ k.transpose(-1, -2) / d**0.5, -1) @ v
    assert torch.allclose(whole, plain.transpose(1, 2).reshape(50, 6, 64), atol=1e-6)


def test_control_reads_above_the_program_on_the_cpu(tiny_vda):
    r = calibrate.readings(tiny_vda, 2**31 + 5, control=True, device="cpu")
    assert r["control"]["depth_err_vs_bf16"] > r["program"]["depth_err_vs_bf16"], r


def swapped(self, frames, size):
    """The timed path with two frames' depth maps swapped where they are produced."""
    depth = SOUND(self, frames, size).clone()
    depth[[0, 1]] = depth[[1, 0]]
    return depth


def one_by_one(self, frames, size):
    """The frames computed as clips of one: what a model that ignores time gives."""
    return torch.cat([SOUND(self, frames[i:i + 1], size) for i in range(frames.shape[0])])


@pytest.mark.parametrize("fault", [None, swapped, one_by_one], ids=["sound", "swapped", "one_by_one"])
def test_a_run_on_the_cpu(tiny_vda, fault, monkeypatch):
    """A whole run of the tiny VDA through ``cell.run``: correct on the sound
    path, not correct with two frames swapped or with the clip's frames
    computed alone."""
    if fault is not None:
        monkeypatch.setattr(DPTModel, "inference_rgb_device", fault)
    cell = spec.Cell(tiny_vda.workload, tiny_vda.config, tiny_vda.traffic, tiny_vda.limits,
                     [{"name": "frames_per_s", "unit": "frames/s"}])
    result = cell_run.run(cell, 2**33 + 77, 0.5, False, "cpu", time.perf_counter(), log=lambda line: None)
    assert result["correct"] == (fault is None), result["checks"]


def test_layout_is_the_synthetic_original_layout():
    """The benchmark's layout (plus the computed ``pe`` buffers) holds the
    same keys and shapes as the port's own synthetic original checkpoint,
    which its converter loads strictly, at the tiny widths."""
    config = tiny_config(spec.load_json(spec.BENCH_DIR / "tests" / "data" / "configs" / "tiny_dav2.json"))
    sd = spec.family_module("weights", FAMILY).generate(config, 1, "cpu", torch.float32)
    synthetic = random_original_video_depth_anything_state_dict(config)
    synthetic.pop("pretrained.mask_token")  # unused; the converter skips it
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in synthetic.items()}


def test_full_layout_is_read_as_the_configuration():
    """The full-size layout, by shapes alone on the ``meta`` device, is what the
    port's converter reads as VDA ViT-L: 24 blocks of 16 heads at width 1024,
    the published taps, four temporal modules at 1024, 1024, 256, 256 of two
    attention blocks, 32 frames; no key of the file that the port also holds
    differs; the modules hold about 49 M parameters."""
    config = full_config()
    layout = spec.family_module("weights", FAMILY).layout(config)
    sd = {key: torch.empty(shape, device="meta") for key, shape, _, _ in layout}
    gen = spec.family_module("weights", FAMILY)
    sd[gen.pe_key(0, 0)] = torch.empty(1, 32, 1024, device="meta")
    port = importlib.import_module(config["converter"]).get_config_from_state_dict(sd)
    assert port["encoder_taps"] == [4, 11, 17, 23] and port["num_heads"] == 16 and port["num_blocks"] == 24
    assert port["temporal_channels"] == [1024, 1024, 256, 256] and port["num_frames"] == 32
    assert program.port_config_matches(SimpleNamespace(config=port), config) == []
    motion = sum(t.numel() for k, t in sd.items() if ".motion_modules." in k and not k.endswith(".pe"))
    assert 48.0e6 < motion < 50.0e6, motion
    assert motion == sum(22 * c * c + 21 * c for c in (1024, 1024, 256, 256))  # products, biases, norms


def test_the_port_sizes_the_cells_frames(tiny_vda):
    cell = spec.load_cell(WORKLOAD)
    assert frames.scaled_hw(cell.config, cell.traffic) == (532, 924)
    config = dict(tiny_vda.config, dtype="float32")
    sd = spec.family_module("weights", FAMILY).generate(config, 1, "cpu", torch.float32)
    model = program.build(config, sd, "cpu")
    t = cell.traffic
    assert tuple(model.compute_scaled_hw(t["frame_hw"], t["max_side"], t["square"])) == (532, 924)


def test_counts_by_hand():
    """532x924 (38 x 66 patches, 2509 tokens), one clip of 32 frames. The
    temporal modules' products, 44 C^2 a token: 44 1024^2 (80256 + 20064)
    + 44 256^2 (80256 + 321024) = 5.786 TFLOP a clip; their attention 4 T C
    a token and block: 0.0526 TFLOP."""
    config = full_config()
    counts = spec.family_module("counts", FAMILY)
    c = counts.counts(config, (532, 924), 32)
    assert counts.module_grids((38, 66)) == [(38, 66), (19, 33), (38, 66), (76, 132)]
    products, attention = counts.temporal_parts(config, (38, 66), 32)
    assert sum(f for f, _ in products) / 1e12 == pytest.approx(5.786, abs=0.001)
    assert sum(f for f, _ in products) == 44 * (1024**2 * (80256 + 20064) + 256**2 * (80256 + 321024))
    assert sum(f for f, _ in attention) == 2 * 4 * 32 * (1024 * (80256 + 20064) + 256 * (80256 + 321024))
    assert c["temporal"]["flops"] / 1e12 == pytest.approx(5.838, abs=0.001)
    n = 2509
    encoder_block = 2 * n * 12 * 1024**2 + 4 * 16 * n**2 * 64
    assert c["tokens"] == n
    assert 24 * 2 * n * 12 * 1024**2 / 1e12 == pytest.approx(1.516, abs=0.001)
    neck = spec.family_module("counts", "depth_anything_v2")
    dav2 = neck.counts(config, (532, 924), 32)["model_flops_per_frame"]
    assert c["model_flops_per_frame"] == pytest.approx(dav2 + c["temporal"]["flops"] / 32, rel=1e-12)
    assert dav2 > 24 * encoder_block
    assert c["model_flops_per_frame"] / 1e12 == pytest.approx(2.85, abs=0.01)
    enc = 24 * 4 * 32 * 16 * n**2 * 64
    assert c["attention"]["flops"] == pytest.approx(enc + sum(f for f, _ in attention), rel=1e-12)
    # the temporal attention is bound by its bytes, q, k, v and out once in bfloat16
    t_bound = sum(b for _, b in attention) / 3.35e12
    assert c["attention"]["bound_s"] == pytest.approx(enc / 989e12 + t_bound, rel=1e-9)
    assert c["temporal"]["bound_s"] > c["temporal"]["flops"] / 989e12


def test_temporal_readers():
    """Two steps of 4 frames. In the neck: a reassembly conv (10 ns), a
    fusion conv (20 ns), the head (5 ns); outside them, in the neck, a
    GroupNorm (30 ns) and an SDPA kernel (10 ns); in the encoder a GEMM (50
    ns). The temporal ops take 80 ns over 8 frames: 1e-5 ms a frame; a
    bound of 20 ns a forward over 40 ns a step: 50 %."""
    from port_bench.cell import Record, Window

    enc = frozenset({"entry", "net", "encoder"})
    neck = frozenset({"entry", "net", "neck"})
    ops = []
    for base in (0, 1000):
        ops += [trace.DeviceOp("nvjet_gemm", base, base + 50, base, enc),
                trace.DeviceOp("conv_reassemble", base + 50, base + 60, base + 1, neck | {"reassemble.2"}),
                trace.DeviceOp("group_norm", base + 60, base + 90, base + 2, neck),
                trace.DeviceOp("flash_fwd_kernel", base + 90, base + 100, base + 3, neck),
                trace.DeviceOp("conv_fusion", base + 100, base + 120, base + 4, neck | {"fusion.2"}),
                trace.DeviceOp("conv_head", base + 120, base + 125, base + 5, neck | {"head"})]
    rec = trace.TraceRecord(ops, (0, 2000), 2, 8, 250e-9, [], 0)
    window = Window(frames=8, steps=2, seconds=1.0, request_s=[0.5] * 2, enqueue_s=[0.1] * 2, peak_bytes=0, begin=0.0)
    cell = spec.Cell({"name": "x"}, {"dtype": "bfloat16"}, {}, {})
    counts = {"model_flops_per_frame": 1.0, "attention": {"bound_s": 1e-9}, "temporal": {"bound_s": 20e-9}}
    device_ms = spec.metric_reader("neck.temporal_device_ms").read
    roofline = spec.metric_reader("neck.temporal_roofline_pct").read
    assert device_ms(Record(cell, counts, 1.0, window, rec)) == pytest.approx(80e-6 / 8)
    assert roofline(Record(cell, counts, 1.0, window, rec)) == pytest.approx(50.0)
    assert spec.metric_reader("neck.device_ms").read(Record(cell, counts, 1.0, window, rec)) == pytest.approx(70e-6 / 8)
    # a cell whose neck launches nothing outside its hooked modules, or whose counts have no temporal part
    bare = trace.TraceRecord([o for o in ops if o.name.startswith(("nvjet", "conv"))], (0, 2000), 2, 8, 250e-9, [], 0)
    assert device_ms(Record(cell, counts, 1.0, window, bare)) is None
    assert roofline(Record(cell, counts, 1.0, window, bare)) is None
    counts.pop("temporal")
    assert roofline(Record(cell, counts, 1.0, window, rec)) is None


def test_the_cell_is_in_the_benchmark():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for name in ("neck.temporal_device_ms", "neck.temporal_roofline_pct"):
        (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert entry["workloads"] == [WORKLOAD] and entry["layer"] == "neck" and entry["moves"] == "frames_per_s"
        reader = spec.metric_reader(name)
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    cell = spec.load_cell(WORKLOAD)
    assert cell.config["family"] == FAMILY and cell.config["reduced"] == [] and cell.workload["chips"] == 1
    assert cell.traffic["batch"] == cell.config["num_frames"] == 32
    names = [m["name"] for m in cell.per_layer]
    assert "neck.temporal_device_ms" in names and "attention.roofline_pct" in names
