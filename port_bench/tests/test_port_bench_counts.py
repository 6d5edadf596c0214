"""Operation and byte counts of the four cells the issue named against values
worked by hand (``beit_l512.b1_1024`` at its shapes: its cell is not in
BENCHMARK.json)."""

import pytest

from port_bench import frames, peaks, spec

# (configuration, batch, scaled size, tokens, model GFLOP per frame, attention TFLOP and GB per forward)
HAND = [
    ("dav2_vitl", 8, (504, 504), 1297, 1224.9, 1.3229, 2.0400),
    ("dav2_vitl", 1, (1428, 1428), 10405, 19144.6, 10.6428, 2.0457),
    ("beit_l512", 8, (512, 512), 1025, 962.7, 0.8262, 2.4191),
    ("beit_l512", 1, (1024, 1024), 4097, 5085.9, 1.6501, 13.6967),
]
SIZES = {"dav2_vitl.batch8_504": (504, 504), "dav2_vitl.b1_1428": (1428, 1428), "beit_l512.batch8_512": (512, 512)}


def vit_l_block_gflop(n):
    """One ViT-L block on one frame, by hand: qkv 2 N 1024 3072, proj 2 N 1024^2,
    fc1 and fc2 2 N 1024 4096 each, attention 4 16 N^2 64."""
    return (2 * n * 1024 * 3072 + 2 * n * 1024 * 1024 + 2 * 2 * n * 1024 * 4096 + 4 * 16 * n * n * 64) / 1e9


def config_file(name):
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


@pytest.mark.parametrize("workload, size", SIZES.items())
def test_cell_scaled_size(workload, size):
    cell = spec.load_cell(workload)
    assert frames.scaled_hw(cell.config, cell.traffic) == size


@pytest.mark.parametrize("config, batch, size, tokens, gflop, att_tflop, att_gb", HAND)
def test_cell_counts(config, batch, size, tokens, gflop, att_tflop, att_gb):
    config = config_file(config)
    c = spec.family_module("counts", config["family"]).counts(config, size, batch)
    assert c["tokens"] == tokens
    assert c["model_flops_per_frame"] / 1e9 == pytest.approx(gflop, rel=1e-4)
    assert c["attention"]["flops"] / 1e12 == pytest.approx(att_tflop, rel=1e-4)
    assert c["attention"]["bytes"] / 1e9 == pytest.approx(att_gb, rel=1e-4)
    # the 24 blocks are most of the work; the rest is the patch embed and the neck (29 % at 504x504)
    assert 24 * vit_l_block_gflop(tokens) < gflop < 24 * vit_l_block_gflop(tokens) * 1.4


def test_attention_bound_by_hand():
    """DA-V2 504, B=8: per block 4 8 16 1297^2 64 = 55.1 GFLOP over 989 TFLOP/s
    (55.7 us) against 4 8 1297 1024 2 B = 85 MB over 3.35 TB/s (25.4 us)."""
    cell = spec.load_cell("dav2_vitl.batch8_504")
    c = spec.family_module("counts", "depth_anything_v2").counts(cell.config, (504, 504), 8)
    per_block = 4 * 8 * 16 * 1297**2 * 64
    assert c["attention"]["bound_s"] == pytest.approx(24 * per_block / 989e12)
    # BEiT 1024: the 16 x 4097^2 bias layer in bf16 makes each block bytes-bound
    c = spec.family_module("counts", "beit").counts(config_file("beit_l512"), (1024, 1024), 1)
    layer_bytes = (4 * 4097 * 1024 + 16 * 4097**2) * 2
    assert c["attention"]["bound_s"] == pytest.approx(24 * layer_bytes / peaks.HBM_BYTES_PER_S)


def test_dav2_504_frame_by_hand():
    """DA-V2 ViT-L at 504x504 (a 36 x 36 grid), one frame, term by term."""
    g = 36 * 36
    neck = (2 * g * 1024 * (256 + 512 + 1024 + 1024)  # the four 1x1 projections
            + 2 * 256 * 256 * 16 * g + 2 * 512 * 512 * 4 * g + 2 * 1024 * 1024 * 9 * 18 * 18  # the resamples
            + 2 * 256 * 9 * (256 * 144**2 + 512 * 72**2 + 1024 * 36**2 + 1024 * 18**2)  # layer*_rn
            + 2 * 256 * 256 * 9 * (4 * (144**2 + 72**2 + 36**2) + 2 * 18**2)  # residual units
            + 2 * 256 * 256 * 4 * (144**2 + 72**2 + 36**2 + 18**2)  # out_conv after each x2
            + 2 * 128 * 256 * 9 * 288**2 + 2 * 32 * 128 * 9 * 504**2 + 2 * 32 * 504**2)  # the head
    total = 2 * 1024 * 3 * 14 * 14 * g + 24 * vit_l_block_gflop(1297) * 1e9 + neck
    cell = spec.load_cell("dav2_vitl.batch8_504")
    c = spec.family_module("counts", "depth_anything_v2").counts(cell.config, (504, 504), 8)
    assert c["model_flops_per_frame"] == pytest.approx(total, rel=1e-12)
