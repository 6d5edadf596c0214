"""Fusion scaling in the PyTorch port, as tests/test_fusion_scaling.py holds
the JAX package: the head's upsample factor comes from the family spec (P/8
for Depth-Anything, 2 for BEiT and SwinV2, where P/8 would give SwinV2's
patch 4 a wrong 0.5), and fusion plus head driven by hand at unit scales
give the model's own forward. Beyond the JAX test: non-unit
``input_scales`` give the JAX ``fusion_forward``'s map on the same
reassembly maps (1e-4 of the reference's largest magnitude, float32), and the
port's fusion_scaling script runs on a toy SwinV2 checkpoint on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from muggled_dpt_tpu.make_beit_dpt import make_beit_dpt as jax_make_beit
from muggled_dpt_tpu.make_depthanythingv1_dpt import make_depthanythingv1_dpt as jax_make_da_v1
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_da_v2
from muggled_dpt_tpu.make_swinv2_dpt import make_swinv2_dpt as jax_make_swinv2
from muggled_dpt_tpu.models import dpt_neck as jax_neck
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv1_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2
from muggled_dpt_tpu_torch.experiments import fusion_scaling
from muggled_dpt_tpu_torch.models.dpt_neck import fusion_forward

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
SEED = 5
# the JAX test's tiny models (tests/test_fusion_scaling.py:24-39): factory -> positional args
ARGS = {
    "da_v2": (64, 1, 4, (8, 16, 32, 64), (8, 8), 16),
    "da_v1": (64, 1, 4, (8, 16, 32, 64), (8, 8), 16),
    "beit": (32, 2, 4, (8, 16, 24, 32), (8, 8), 16),
    "swinv2": ((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16),
}
FACTORIES = {"da_v2": (make_depthanythingv2_dpt, jax_make_da_v2), "da_v1": (make_depthanythingv1_dpt, jax_make_da_v1),
            "beit": (make_beit_dpt, jax_make_beit), "swinv2": (make_swinv2_dpt, jax_make_swinv2)}
INPUT_HW = {"da_v2": (56, 84), "da_v1": (84, 56), "beit": (64, 96), "swinv2": (64, 96)}  # multiples of the tiling
EXPECTED_HEAD_UPSAMPLE = {"da_v2": 14 / 8, "da_v1": 14 / 8, "beit": 2.0, "swinv2": 2.0}
SCALES = (0.5, 1.0, 0.0, 2.0)
MAP_REL_MAX = 1e-4


def _port(family):
    return FACTORIES[family][0](*ARGS[family], seed=SEED, device=DEVICE)


def _image():
    return np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)


@pytest.mark.parametrize("family", list(ARGS))
def test_spec_head_upsample(family):
    model = _port(family)
    assert model.spec["head_upsample"] == EXPECTED_HEAD_UPSAMPLE[family]
    assert model.net.head.upsample_factor == model.spec["head_upsample"]


@pytest.mark.parametrize("family", list(ARGS))
def test_manual_fusion_at_unit_scales_equals_forward(family):
    """What the fusion_scaling script does, at unit scales: the full pipeline's output."""
    model = _port(family)
    image_bchw = model.prepare_image_bgr(_image())
    depth_full = model.forward(image_bchw)
    _, internals = model.forward_with_internals(image_bchw)
    with torch.inference_mode():
        fused = fusion_forward(internals["reassembly_maps"], model.net.fusion, input_scales=(1.0, 1.0, 1.0, 1.0))
        depth_manual = model.net.head(fused)
    assert depth_manual.shape == depth_full.shape
    torch.testing.assert_close(depth_manual, depth_full, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fused, internals["fused_map"], rtol=0, atol=0)


@pytest.mark.parametrize("family", list(ARGS))
def test_input_scales_match_jax(family):
    """(f1, f2, f3, f4) = (0.5, 1, 0, 2): f4 on the top block's input, f3-f1
    on the prior fusion map before each residual add, as JAX
    ``models/dpt_neck.py:113-128``; both on the JAX model's reassembly maps."""
    model = _port(family)
    jm = FACTORIES[family][1](*ARGS[family], dtype=jnp.float32, seed=SEED)
    x = np.random.default_rng(1).standard_normal((1, *INPUT_HW[family], 3)).astype(np.float32)
    _, jint = jax.jit(jm.spec["forward_capture"])(jm.params, x)  # the JAX capture, NHWC in, under one jit
    jax_fusion = jax.jit(lambda maps, params: jax_neck.fusion_forward(maps, params, input_scales=SCALES))
    want = np.asarray(jax_fusion(jint["reassembly_maps"], jm.params["fusion"]))
    maps = [torch.from_numpy(np.asarray(m).transpose(0, 3, 1, 2).copy()) for m in jint["reassembly_maps"]]
    with torch.inference_mode():
        got = fusion_forward(maps, model.net.fusion, input_scales=SCALES).numpy()
        unit = fusion_forward(maps, model.net.fusion).numpy()
    want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= MAP_REL_MAX * float(np.abs(want).max())
    assert float(np.abs(got - unit).max()) > 1e-2 * float(np.abs(unit).max())  # the scales change the map


def test_fusion_scaling_script_swinv2(tmp_path, capsys):
    """The script itself on a SwinV2 checkpoint (the family where P/8 would
    give a wrong 0.5x head), on the CPU."""
    cfg = {"features_per_stage": [16, 32, 64, 128], "heads_per_stage": [2, 4, 4, 8], "layers_per_stage": [2, 2, 2, 2],
           "base_patch_grid_hw": (16, 16), "window_size_hw": (4, 4), "pretrained_window_sizes_per_stage": [None] * 4,
           "fusion_channels": 16, "patch_size_px": 4}
    ckpt = str(tmp_path / "swin2_tiny_256.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in random_swinv2(cfg, seed=9).items()}, ckpt)
    out = tmp_path / "out"
    fusion_scaling.main(["-m", ckpt, "-f", "1,1,1,1", "-o", str(out), "-d", "cpu"])
    assert "scales=" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == ["f1_1_1_1.png"]
