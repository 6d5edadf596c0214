"""Every entry of BENCHMARK.json finds its files by name, and the files agree
with the entries and the contract's form."""

import json
import re

import pytest

from port_bench import frames, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("features_per_token", "num_heads", "head_dim", "mlp_hidden", "reassembly_features_list", "fusion_channels",
          "patch_size_px")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and BENCH["command"][1] == "port_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(workload):
    cell = spec.load_cell(workload)
    assert cell.workload["chips"] == 1
    frames.check_traffic(cell.traffic)
    size = frames.scaled_hw(cell.config, cell.traffic)
    assert size[0] % cell.config["patch_size_px"] == 0
    for kind in ("weights", "reference", "counts"):
        spec.family_module(kind, cell.config["family"])
    assert set(cell.limits["numbers"]) >= {"depth_err_vs_bf16"}
    assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for name, entry in cell.limits["numbers"].items():
        assert entry["lower"] < entry["limit"] < entry["upper"], name


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((spec.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
    assert not set(config["reduced"]) & set(WIDTHS)
    assert data["features_per_token"] == data["num_heads"] * data["head_dim"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    reader = spec.metric_reader(metric["name"])
    assert reader.UNIT == metric["unit"] and UNIT.match(metric["unit"]) and NAME.match(metric["name"])
    if "layer" in metric:
        assert reader.LAYER == metric["layer"] and reader.MOVES == metric["moves"] == "frames_per_s"
    else:
        assert reader.MOVES == metric["name"] and 0.01 <= metric["bound"] <= 0.25
    assert metric["source"] in ("host_clock", "device_trace", "program_span", "program_counter")


def test_names_and_sizes():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["name"] == f"{w['config']}.{w['traffic']}"


def test_a_swinv2_cell_needs_only_files(tiny_cell):
    """A SwinV2 configuration, whose converter names its widths per stage and
    whose tiling is eight patches, loads by name; the harness sizes its frames
    as the port does, finds the port's widths equal to the file's, and hooks
    its layers: such a cell adds files and edits none of the harness."""
    import torch

    from muggled_dpt_tpu_torch.checkpoints import swinv2

    from port_bench import program, trace

    cell = tiny_cell("tiny_swinv2.tiny_b2_swin")
    frames.check_traffic(cell.traffic)
    sd = {k: torch.from_numpy(v) for k, v in swinv2.random_original_state_dict(cell.config, 0).items()}
    model = program.build(dict(cell.config, dtype="float32"), sd, "cpu")
    assert program.port_config_matches(model, cell.config) == []
    assert program.port_config_matches(model, dict(cell.config, heads_per_stage=[2, 4, 8, 8]))
    size = frames.scaled_hw(cell.config, cell.traffic)
    t = cell.traffic
    assert tuple(model.compute_scaled_hw(t["frame_hw"], t["max_side"], t["square"])) == size == (96, 96)
    pool = frames.make_pool(t, 2**31 + 7, "cpu")
    with trace.layer_spans(model.net):
        depth = model.inference_rgb_device(pool[frames.step_frames(t, 0)], size)
    assert tuple(depth.shape) == (t["batch"], *size)
