"""The control: the plain reference with every product's operands in float8
e4m3 (the precision below the configuration's bfloat16), put in the
program's place, must come out not correct.

On the card, each cell at its own size and on a seed of its own reads the
program under its limit and the control over it (``calibrate.readings``, as
the limits were set). On the CPU, the tiny cells show the same order (at these widths the two
are closer: the limits come from the card)."""

import json

import pytest

from port_bench import calibrate, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", ["tiny_dav2.tiny_b2", "tiny_beit.tiny_b2_beit"])
def test_control_reads_above_the_program_on_the_cpu(name, tiny_cell):
    r = calibrate.readings(tiny_cell(name), 2**31 + 5, control=True, device="cpu")
    assert r["control"]["depth_err_vs_bf16"] > r["program"]["depth_err_vs_bf16"], r


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_at_the_cells_size(name, card):
    cell = spec.load_cell(name)
    r = calibrate.readings(cell, 2**31 + 2024, control=True)
    limit = cell.limits["numbers"]["depth_err_vs_bf16"]["limit"]
    assert r["program"]["depth_err_vs_bf16"] <= limit < r["control"]["depth_err_vs_bf16"], r
