"""The plain reference against the port's own model at a tiny width, on the
CPU, in float32: the same original-layout weights and frames, the port
through its facade entry (whose attention falls back to its plain version
on the CPU)."""

import pytest
import torch

from port_bench import check, frames, program, spec
from port_bench.reference import no_tf32

CELLS = ["tiny_dav2.tiny_b2", "tiny_beit.tiny_b2_beit"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_port_in_float32(name, tiny_cell):
    cell = tiny_cell(name)
    config = dict(cell.config, dtype="float32")
    sd = spec.family_module("weights", config["family"]).generate(config, 2**31 + 7, "cpu", torch.float32)
    model = program.build(config, sd, "cpu")
    assert program.port_config_matches(model, config) == []
    pool = frames.make_pool(cell.traffic, 5, "cpu")
    size = frames.scaled_hw(config, cell.traffic)
    x = pool[frames.step_frames(cell.traffic, 1)]
    got = model.inference_rgb_device(x, size)
    with no_tf32():
        ref = spec.family_module("reference", config["family"]).forward(sd, config, x, size)
    errors = check.frame_errors(got, ref)
    assert max(errors) < 2e-5, errors
    assert ref.shape == (cell.traffic["batch"], *size) and float(ref.abs().mean()) > 0.1


@pytest.mark.parametrize("name", CELLS)
def test_reference_resizes_what_the_port_derives(name, tiny_cell):
    """The tiny cells' grids (6 x 6) differ from the base grid (4 x 4), so the
    reference resizes the position embedding or the relative-position table."""
    cell = tiny_cell(name)
    size = frames.scaled_hw(cell.config, cell.traffic)
    grid = (size[0] // cell.config["patch_size_px"], size[1] // cell.config["patch_size_px"])
    assert grid != tuple(cell.config["base_patch_grid_hw"])


def test_beit_index_matches_the_port():
    from muggled_dpt_tpu_torch.models.beit import relative_position_tensor

    from port_bench.reference.beit import relative_position_index

    for grid in ((4, 4), (3, 5), (6, 2)):
        assert torch.equal(relative_position_index(grid, "cpu"), relative_position_tensor(grid).long())


def test_weights_are_the_same_from_the_same_seed():
    from port_bench.weights import checksum

    cell = spec.load_cell("dav2_vitl.batch8_504")
    gen = spec.family_module("weights", "depth_anything_v2")
    config = dict(cell.config, num_blocks=1)
    a, b = gen.generate(config, 2**31 + 3, "cpu", torch.bfloat16), gen.generate(config, 2**31 + 3, "cpu", torch.bfloat16)
    c = gen.generate(config, 2**31 + 4, "cpu", torch.bfloat16)
    assert checksum(a) == checksum(b) != checksum(c)
    assert all(t.dtype == torch.bfloat16 for t in a.values())
