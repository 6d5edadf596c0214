"""The SwinV2 configuration's files: the plain reference against the port on
the CPU at a tiny width, the control above the program, the weights from the
seed, the full-size layout as the port's converter reads it, the counts at
384x384 and B=32 worked by hand, and the glue metric's reading.

The tiny cell (``tiny_swinv2.tiny_b2_swin``) runs at 96x96 with window 4: its
stage grids 24, 12, 6 and 3 shift at 24 and 12, fit one 6x6 window at 6 and
clip to 3 at 3, the pattern of the published model at 384x384 (96 and 48
shift, 24 is one window, 12 clips the window to 12)."""

import pytest
import torch

from port_bench import calibrate, check, frames, peaks, program, spec, trace
from port_bench.counts import swinv2 as counts
from port_bench.reference import no_tf32
from port_bench.reference import swinv2 as reference
from port_bench.weights import checksum
from port_bench.weights import swinv2 as weights

TINY = "tiny_swinv2.tiny_b2_swin"
CELL = "swinv2_l384.batch32_384"


def full_config():
    return spec.load_cell(CELL).config


def test_tiny_cell_has_the_published_pattern(tiny_cell):
    cell = tiny_cell(TINY)
    size = frames.scaled_hw(cell.config, cell.traffic)
    plans = [(grid, win, shifts) for grid, _, _, _, win, shifts in counts.stages(cell.config, size)]
    assert plans == [((24, 24), (4, 4), True), ((12, 12), (4, 4), True), ((6, 6), (6, 6), False),
                     ((3, 3), (3, 3), False)]
    full = [(grid, win, shifts) for grid, _, _, _, win, shifts in counts.stages(full_config(), (384, 384))]
    assert full == [((96, 96), (24, 24), True), ((48, 48), (24, 24), True), ((24, 24), (24, 24), False),
                    ((12, 12), (12, 12), False)]


def test_reference_matches_port_in_float32(tiny_cell):
    cell = tiny_cell(TINY)
    config = dict(cell.config, dtype="float32")
    sd = weights.generate(config, 2**31 + 7, "cpu", torch.float32)
    model = program.build(config, sd, "cpu")
    assert program.port_config_matches(model, config) == []
    pool = frames.make_pool(cell.traffic, 5, "cpu")
    size = frames.scaled_hw(config, cell.traffic)
    x = pool[frames.step_frames(cell.traffic, 1)]
    got = model.inference_rgb_device(x, size)
    with no_tf32():
        ref = reference.forward(sd, config, x, size)
    errors = check.frame_errors(got, ref)
    assert max(errors) < 2e-5, errors
    assert ref.shape == (cell.traffic["batch"], *size) and float(ref.abs().mean()) > 0.1


def test_control_reads_above_the_program_on_the_cpu(tiny_cell):
    """The port in bfloat16 from bfloat16 weights, against the fp8 e4m3 control."""
    r = calibrate.readings(tiny_cell(TINY), 2**31 + 5, control=True, device="cpu")
    assert r["control"]["depth_err_vs_bf16"] > r["program"]["depth_err_vs_bf16"], r


def test_weights_are_the_same_from_the_same_seed():
    config = dict(full_config(), layers_per_stage=[1, 1, 1, 1])
    a, b, c = (weights.generate(config, seed, "cpu", torch.bfloat16) for seed in (2**31 + 3, 2**31 + 3, 2**31 + 4))
    assert checksum(a) == checksum(b) != checksum(c)
    assert all(t.dtype == torch.bfloat16 for t in a.values())


def test_full_size_layout_is_read_as_the_file_widths():
    """The port's converter reads the configuration file's widths from the
    layout's shapes alone (tensors on the meta device hold no data)."""
    from muggled_dpt_tpu_torch.checkpoints.swinv2 import get_config_from_state_dict

    config = full_config()
    layout = weights.layout(config)
    sd = {key: torch.empty(shape, device="meta") for key, shape, _, _ in layout}
    port = get_config_from_state_dict(sd)
    shared = set(port) & set(config)
    assert {"features_per_stage", "heads_per_stage", "layers_per_stage", "window_size_hw",
            "pretrained_window_sizes_per_stage", "base_patch_grid_hw", "fusion_channels", "patch_size_px"} <= shared
    assert {k: list(port[k]) if isinstance(port[k], tuple) else port[k] for k in shared} == {k: config[k] for k in shared}
    assert sd["pretrained.model.layers.0.blocks.1.attn_mask"].shape == (16, 576, 576)
    params = sum(torch.Size(shape).numel() for key, shape, _, _ in layout if not key.endswith("attn_mask"))
    assert 0.20e9 < params < 0.22e9, params


def test_reference_constants_match_the_port():
    """The window plan, shift mask, coordinate table and index that the
    reference works out itself are the port's."""
    from muggled_dpt_tpu_torch.models import swinv2 as port

    for grid in (3, 6, 12, 24, 36, 48, 60, 96, 120):
        for win in (4, 24):
            (wh, ww), (sh, sw) = port.window_plan((grid, grid), (win, win))
            assert reference.window_and_shift(grid, win) == (wh, sh), (grid, win)
    for grid, win, shift in ((8, 4, 2), (96, 24, 12), (48, 24, 12)):
        ours = reference.shift_mask(grid, grid, win, win, shift, shift, "cpu")
        assert torch.equal(ours, port.shift_mask((grid, grid), (win, win), (shift, shift), "cpu"))
    for win, pretrained in ((24, 12), (12, 6), (4, None)):
        assert torch.allclose(reference.relative_coords_table(win, win, pretrained, "cpu"),
                              port.cpb_coords_table((win, win), pretrained), rtol=0, atol=1e-6)
        assert torch.equal(reference.relative_position_index(win, win, "cpu"), port.cpb_index((win, win)))


def test_counts_at_384_by_hand():
    """B=32 at 384x384: 9216, 2304, 576 and 144 tokens a stage; each of the
    24 blocks 2 T C 12 C = 8.15 GFLOP of GEMMs a frame (T C^2 is the same at
    every stage); window attention 4 nW H A^2 D a frame."""
    c = counts.counts(full_config(), (384, 384), 32)
    assert c["tokens"] == 96 * 96
    block = 2 * 9216 * 192 * 12 * 192
    assert block == 2 * 2304 * 384 * 12 * 384 == 2 * 576 * 768 * 12 * 768 == 2 * 144 * 1536 * 12 * 1536
    attention = (2 * 4 * 16 * 6 * 576**2 * 32 + 2 * 4 * 4 * 12 * 576**2 * 32 + 18 * 4 * 1 * 24 * 576**2 * 32
                 + 2 * 4 * 1 * 48 * 144**2 * 32)
    merges = 2 * 2304 * 768 * 384 + 2 * 576 * 1536 * 768 + 2 * 144 * 3072 * 1536
    embed = 2 * 192 * 3 * 16 * 9216
    cf = 256
    neck = (2 * cf * 9 * (192 * 96**2 + 384 * 48**2 + 768 * 24**2 + 1536 * 12**2)  # layer*_rn
            + 2 * cf * cf * 9 * (4 * (96**2 + 48**2 + 24**2) + 2 * 12**2)  # residual units
            + 2 * cf * cf * (192**2 + 96**2 + 48**2 + 24**2)  # out_conv after each x2
            + 2 * 128 * cf * 9 * 192**2 + 2 * 32 * 128 * 9 * 384**2 + 2 * 32 * 384**2)  # the head
    assert c["model_flops_per_frame"] == pytest.approx(embed + 24 * block + attention + merges + neck, rel=1e-12)
    assert c["model_flops_per_frame"] / 1e9 == pytest.approx(342.513, rel=1e-5)
    assert c["attention"]["flops"] == pytest.approx(32 * attention, rel=1e-12)
    qkvo = 4 * 32 * (2 * 9216 * 192 + 2 * 2304 * 384 + 18 * 576 * 768 + 2 * 144 * 1536)  # q, k, v, out of each block
    bias = 2 * 6 * 576**2 + 2 * 12 * 576**2 + 18 * 24 * 576**2 + 2 * 48 * 144**2
    masks = 16 * 576**2 + 4 * 576**2  # the odd block of the two shifting stages
    assert c["attention"]["bytes"] == pytest.approx(2 * (qkvo + bias + masks), rel=1e-12)


def test_attention_bound_is_the_window_kernels():
    """``bound_s`` is the sum over the 24 blocks of the window kernel's own
    ``window_bound``."""
    from muggled_dpt_tpu_torch.ops.kernels.window_attention import window_bound

    c = counts.counts(full_config(), (384, 384), 32)
    total = 0.0
    for (gh, gw), _, heads, blocks, (wh, ww), shifts in counts.stages(full_config(), (384, 384)):
        a = wh * ww
        for i in range(blocks):
            total += window_bound(32, gh * gw // a, a, heads, shifts and i % 2 == 1)["bound_ms"]
    assert c["attention"]["bound_s"] * 1e3 == pytest.approx(total, rel=1e-12)
    assert c["attention"]["bound_s"] > c["attention"]["flops"] / peaks.FLOPS_PER_S["bfloat16"]


def test_glue_metric_leaves_out_products_and_attention():
    """Of the encoder's operations the glue reads the rest: here the
    elementwise 4 ns and the layer norm 2 ns, not the GEMM, the cuDNN
    kernel, the window attention or the neck's operation; over 2 frames."""
    reader = spec.metric_reader("encoder.glue_device_ms")
    enc = frozenset({"step", "entry", "net", "encoder"})
    ops = [trace.DeviceOp("nvjet_tst_128x216_64x4_2x1_v_bz_coopA_bias_TNT", 0, 10, 0, enc),
           trace.DeviceOp("sm90_xmma_fprop_implicit_gemm_bf16bf16", 10, 20, 0, enc),
           trace.DeviceOp("void_cudnn::engines_precompiled::nchwToNhwcKernel", 20, 25, 0, enc),
           trace.DeviceOp("void__anonymous_namespace_::wa_sm90___nv_bfloat16", 25, 40, 0, enc),
           trace.DeviceOp("void_at::native::vectorized_elementwise_kernel_4", 40, 44, 0, enc),
           trace.DeviceOp("void_at::native::vectorized_layer_norm_kernel", 44, 46, 0, enc),
           trace.DeviceOp("void_at::native::vectorized_elementwise_kernel_4", 46, 60, 0, enc | {"neck"})]
    record = type("R", (), {"trace": trace.TraceRecord(ops, (0, 60), 1, 2, 60e-9, [], 0)})()
    assert reader.read(record) == pytest.approx(6e-9 * 1e3 / 2)
    record.trace.ops = []
    assert reader.read(record) is None
