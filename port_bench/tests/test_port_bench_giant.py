"""The Depth-Anything V2 ViT-Giant family (``depth_anything_v2_giant``): its
reference against the port at a tiny width on the CPU, its control, its
weights at full width as the port's converter reads them, its counts by hand,
and the ``encoder.dense_roofline_pct`` reader on a synthetic trace.

The tiny Giant is ``tiny_dav2``'s configuration with the family, ``is_giant``
and the SwiGLU hidden width the port sizes (``swiglu_hidden(128)``), built
here: the test data's files stay as they are."""

import time
from types import SimpleNamespace

import pytest
import torch

from muggled_dpt_tpu_torch.checkpoints.random_init import swiglu_hidden
from muggled_dpt_tpu_torch.dpt import DPTModel

from port_bench import calibrate, check, frames, program, spec, trace
from port_bench import cell as cell_run
from port_bench.reference import no_tf32

FAMILY = "depth_anything_v2_giant"
WORKLOAD = "dav2_vitg.batch8_504"
SOUND = DPTModel.inference_rgb_device


@pytest.fixture
def tiny_giant(tiny_cell):
    base = tiny_cell("tiny_dav2.tiny_b2")
    config = dict(base.config, name="tiny_dav2g", family=FAMILY, is_giant=True, mlp_hidden=swiglu_hidden(128))
    return spec.Cell(dict(base.workload, name="tiny_dav2g.tiny_b2", config="tiny_dav2g"), config, base.traffic,
                     base.limits)


def full_config():
    return spec.load_json(spec.BENCH_DIR / "configs" / "dav2_vitg.json")


def test_reference_matches_port_in_float32(tiny_giant):
    config = dict(tiny_giant.config, dtype="float32")
    sd = spec.family_module("weights", FAMILY).generate(config, 2**31 + 7, "cpu", torch.float32)
    assert sd["pretrained.blocks.0.mlp.w12.weight"].shape == (2 * 344, 128)
    model = program.build(config, sd, "cpu")
    assert program.port_config_matches(model, config) == [] and model.config["is_giant"]
    traffic = tiny_giant.traffic
    pool = frames.make_pool(traffic, 5, "cpu")
    size = frames.scaled_hw(config, traffic)
    x = pool[frames.step_frames(traffic, 1)]
    got = model.inference_rgb_device(x, size)
    with no_tf32():
        ref = spec.family_module("reference", FAMILY).forward(sd, config, x, size)
    errors = check.frame_errors(got, ref)
    assert max(errors) < 2e-5, errors
    assert ref.shape == (traffic["batch"], *size) and float(ref.abs().mean()) > 0.1


def test_control_reads_above_the_program_on_the_cpu(tiny_giant):
    r = calibrate.readings(tiny_giant, 2**31 + 5, control=True, device="cpu")
    assert r["control"]["depth_err_vs_bf16"] > r["program"]["depth_err_vs_bf16"], r


def flipped(self, frames, size):
    """The timed path with one frame's depth mirrored where it is produced."""
    depth = SOUND(self, frames, size).clone()
    depth[0] = depth[0].flip(-1)
    return depth


@pytest.mark.parametrize("fault", [None, flipped], ids=["sound", "flipped"])
def test_a_run_on_the_cpu(tiny_giant, fault, monkeypatch):
    """A whole run of the tiny Giant through ``cell.run`` (the card's look
    skipped): correct on the sound path, not correct with a frame altered."""
    if fault is not None:
        monkeypatch.setattr(DPTModel, "inference_rgb_device", fault)
    cell = spec.Cell(tiny_giant.workload, tiny_giant.config, tiny_giant.traffic, tiny_giant.limits,
                     [{"name": "frames_per_s", "unit": "frames/s"}])
    result = cell_run.run(cell, 2**33 + 77, 0.5, False, "cpu", time.perf_counter(), log=lambda line: None)
    assert result["correct"] == (fault is None), result["checks"]
    assert result["metrics"]["frames_per_s"]["value"] > 0


def test_weights_are_the_same_from_the_same_seed():
    from port_bench.weights import checksum

    gen = spec.family_module("weights", FAMILY)
    config = dict(full_config(), num_blocks=1)
    a, b = gen.generate(config, 2**31 + 3, "cpu", torch.bfloat16), gen.generate(config, 2**31 + 3, "cpu", torch.bfloat16)
    c = gen.generate(config, 2**31 + 4, "cpu", torch.bfloat16)
    assert checksum(a) == checksum(b) != checksum(c)
    assert all(t.dtype == torch.bfloat16 for t in a.values())


def test_full_layout_is_read_as_the_configuration():
    """The full-size layout, by shapes alone on the ``meta`` device, is what
    the port's converter reads as ViT-Giant: 40 SwiGLU blocks of 24 heads at
    width 1536, ``w12`` of 8192 rows, the 1536 / 384 neck; no key of the file
    that the port also holds differs."""
    import importlib

    config = full_config()
    layout = spec.family_module("weights", FAMILY).layout(config)
    sd = {key: torch.empty(shape, device="meta") for key, shape, _, _ in layout}
    assert not any(".mlp.fc" in key for key in sd)
    port = importlib.import_module(config["converter"]).get_config_from_state_dict(sd)
    assert port["is_giant"] and port["num_heads"] == 24 and port["num_blocks"] == 40
    assert sd["pretrained.blocks.39.mlp.w12.weight"].shape == (8192, 1536) == (2 * swiglu_hidden(1536), 1536)
    assert sd["pretrained.blocks.39.mlp.w3.weight"].shape == (1536, 4096)
    assert program.port_config_matches(SimpleNamespace(config=port), config) == []
    parameters = sum(t.numel() for t in sd.values())
    assert 1.25e9 < parameters < 1.27e9, parameters


def test_the_port_sizes_the_cells_frames(tiny_giant):
    cell = spec.load_cell(WORKLOAD)
    assert frames.scaled_hw(cell.config, cell.traffic) == (504, 504)
    model = program.build(dict(tiny_giant.config, dtype="float32"),
                          spec.family_module("weights", FAMILY).generate(tiny_giant.config, 1, "cpu", torch.float32), "cpu")
    t = cell.traffic
    assert tuple(model.compute_scaled_hw(t["frame_hw"], t["max_side"], t["square"])) == (504, 504)


def test_counts_by_hand():
    """504x504 (36 x 36 patches, 1297 tokens), B=8. Per block and frame: qkv
    2 N 4608 1536 = 18.36 GFLOP, proj 6.12, w12 2 N 8192 1536 = 32.64, w3
    2 N 1536 4096 = 16.32, attention 4 24 N^2 64 = 10.34."""
    config = full_config()
    c = spec.family_module("counts", FAMILY).counts(config, (504, 504), 8)
    n = 1297
    dense_block = 2 * n * 1536 * (4608 + 1536 + 8192) + 2 * n * 4096 * 1536
    assert dense_block / 1e9 == pytest.approx(73.44, abs=0.01)
    assert c["tokens"] == n
    assert c["model_flops_per_frame"] / 1e9 == pytest.approx(4267.6, abs=0.05)
    assert c["attention"]["flops"] / 1e12 == pytest.approx(3.3074, abs=5e-5)
    assert c["attention"]["bytes"] / 1e9 == pytest.approx(5.100, abs=5e-4)
    assert c["attention"]["bound_s"] == pytest.approx(40 * 4 * 8 * 24 * n**2 * 64 / 989e12)
    patch = 2 * 1536 * 3 * 14 * 14 * 36 * 36
    assert c["encoder_dense"]["flops"] == pytest.approx(8 * (patch + 40 * dense_block), rel=1e-12)
    assert c["encoder_dense"]["flops"] / 1e12 == pytest.approx(23.52, abs=0.005)
    # every product is compute-bound at B=8: the bound is the operations over the peak
    assert c["encoder_dense"]["bound_s"] == pytest.approx(c["encoder_dense"]["flops"] / 989e12, rel=1e-12)
    assert c["encoder_dense"]["bytes"] / c["encoder_dense"]["flops"] < 3.35e12 / 989e12


def test_dense_roofline_reader():
    """Two steps of 4 frames: in the encoder a GEMM (30 ns), the gate (10 ns)
    and an attention kernel (20 ns, left out); in the neck a conv (50 ns,
    left out). A bound of 10 ns a forward over 40 ns of each step's
    non-attention encoder work: 25 %."""
    from port_bench.cell import Record, Window

    enc, neck = frozenset({"entry", "net", "encoder"}), frozenset({"entry", "net", "neck", "head"})
    ops = []
    for base in (0, 1000):
        ops += [trace.DeviceOp("nvjet_tst_gemm", base, base + 30, base, enc),
                trace.DeviceOp("elementwise_kernel<silu>", base + 30, base + 40, base + 1, enc),
                trace.DeviceOp("fa_sm90<bf16, 0>", base + 40, base + 60, base + 2, enc),
                trace.DeviceOp("sm90_xmma_fprop", base + 60, base + 110, base + 3, neck)]
    rec = trace.TraceRecord(ops, (0, 2000), 2, 8, 220e-9, [], 0)
    window = Window(frames=8, steps=2, seconds=1.0, request_s=[0.5] * 2, enqueue_s=[0.1] * 2, peak_bytes=0, begin=0.0)
    cell = spec.Cell({"name": "x"}, {"dtype": "bfloat16"}, {}, {})
    read = spec.metric_reader("encoder.dense_roofline_pct").read
    counts = {"model_flops_per_frame": 1.0, "attention": {"bound_s": 1e-9}, "encoder_dense": {"bound_s": 10e-9}}
    assert read(Record(cell, counts, 1.0, window, rec)) == pytest.approx(25.0)
    counts.pop("encoder_dense")
    assert read(Record(cell, counts, 1.0, window, rec)) is None


def test_the_cell_is_in_the_benchmark():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "encoder.dense_roofline_pct"]
    assert entry["workloads"] == [WORKLOAD]
    cell = spec.load_cell(WORKLOAD)
    assert cell.config["family"] == FAMILY and cell.config["reduced"] == [] and cell.workload["chips"] == 1
    assert "encoder.dense_roofline_pct" in [m["name"] for m in cell.per_layer]
