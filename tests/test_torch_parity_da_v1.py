"""Depth-Anything V1 and V2 ViT-Giant end to end: the PyTorch port
(``muggled_dpt_tpu_torch``) against the JAX package on the same tiny
original-format checkpoints, in float32 on the CPU.

Configs, as tests/test_parity_variants.py: F=64 (one head x 64), reassembly
(8, 16, 32, 64), fusion 16, patch 14, base grid 8x8; V1 with 8 blocks, so
its taps (the last 4 blocks, 4-7) differ from V2's (1, 3, 5, 7); Giant with
4 blocks of SwiGLU (hidden 176). The file name picks the family: "v1" or
"anything_vit" means V1, the mlp.w12 keys mean Giant. On CPU tensors the
port's attention runs the kernel's plain version; the JAX package runs XLA
attention. Budget: the repo's f32 mean abs-rel of 1e-3 (README "Numerical
parity"); the two packages differ only in float32 summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.checkpoints.depth_anything import convert_state_dict as jax_convert_state_dict
from muggled_dpt_tpu.checkpoints.random_init import random_original_depth_anything_state_dict as jax_random_state_dict
from muggled_dpt_tpu.make_depthanythingv1_dpt import make_depthanythingv1_dpt as jax_make_random_v1
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_random_v2
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu_torch import make_depthanythingv1_dpt, make_depthanythingv2_dpt, make_dpt_from_state_dict
from muggled_dpt_tpu_torch.checkpoints.depth_anything import convert_state_dict, get_config_from_state_dict
from muggled_dpt_tpu_torch.checkpoints.from_jax import params_from_jax
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict, swiglu_hidden
from muggled_dpt_tpu_torch.ops.kernels.fused_mlp import fused_ln_mlp_residual
from muggled_dpt_tpu_torch.ops.kernels.head_tail import fused_head_tail

BASE = {
    "features_per_token": 64,
    "reassembly_features_list": [8, 16, 32, 64],
    "fusion_channels": 16,
    "patch_size_px": 14,
    "base_patch_grid_hw": (8, 8),
}
CONFIGS = {
    "v1": dict(BASE, num_blocks=8),
    "giant": dict(BASE, num_blocks=4, is_giant=True),
}
FILE_NAMES = {"v1": "depth_anything_v1_tiny.pth", "giant": "depth_anything_v2_vitg_tiny.pth"}
SEED = 31
ABS_REL_BUDGET = 1e-3
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise


def _abs_rel(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).mean() / (np.abs(ref).mean() + 1e-12))


def _save(sd_np: dict, path) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd_np.items()}, str(path))
    return str(path)


def _frame(seed, hw=(90, 120)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {name: _save(random_original_depth_anything_state_dict(cfg, seed=SEED), root / FILE_NAMES[name])
            for name, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def models(ckpts):
    return {name: (jax_make_dpt(path), make_dpt_from_state_dict(path, device=DEVICE)) for name, path in ckpts.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_random_state_dict_is_byte_identical(name):
    ours = random_original_depth_anything_state_dict(CONFIGS[name], seed=SEED)
    theirs = jax_random_state_dict(CONFIGS[name], seed=SEED)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k
    if name == "giant":
        hidden = swiglu_hidden(64)
        assert ours["pretrained.blocks.0.mlp.w12.weight"].shape == (2 * hidden, 64)
        assert ours["pretrained.blocks.0.mlp.w3.weight"].shape == (64, hidden)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_from_jax_equals_own_conversion(name):
    sd = random_original_depth_anything_state_dict(CONFIGS[name], seed=SEED)
    cfg = get_config_from_state_dict(sd)
    ours = convert_state_dict(sd, cfg)
    theirs = params_from_jax(jax_convert_state_dict(sd, cfg))
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape and torch.equal(ours[k], theirs[k]), k
    assert any(".mlp.w12." in k for k in ours) == (name == "giant")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_matches_jax(models, name):
    (jcfg, _), (cfg, model) = models[name]
    assert cfg == jcfg
    assert cfg["is_giant"] == (name == "giant") and not cfg["is_metric"]
    assert model.device == torch.device("cpu") and model.dtype == torch.float32
    taps = model.net.encoder.taps
    assert taps == ((4, 5, 6, 7) if name == "v1" else (0, 1, 2, 3))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("square,side", [(True, 112), (False, 140)])
def test_inference_matches_jax(models, name, square, side):
    (_, jm), (_, tm) = models[name]
    frame = _frame(1)
    want = np.asarray(jm.inference(frame, side, square))
    got = tm.inference(frame, side, square)
    assert tuple(got.shape) == want.shape == (1, *tm.compute_scaled_hw(frame.shape[:2], side, square))
    assert _abs_rel(got.numpy(), want) <= ABS_REL_BUDGET


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_attention_path_matches_kernel_path(ckpts, models, name):
    _, (_, tm) = models[name]
    _, plain = make_dpt_from_state_dict(ckpts[name], enable_optimizations=False, device=DEVICE)
    frame = _frame(2)
    assert _abs_rel(plain.inference(frame, 84).numpy(), tm.inference(frame, 84).numpy()) <= 1e-5


def test_v1_is_taken_from_anything_vit_names(tmp_path):
    """The original V1 release names its files depth_anything_vit{s,b,l}14.pth."""
    path = _save(random_original_depth_anything_state_dict(CONFIGS["v1"], seed=SEED), tmp_path / "depth_anything_vits14.pth")
    jcfg, jm = jax_make_dpt(path)
    cfg, tm = make_dpt_from_state_dict(path, device=DEVICE)
    assert cfg == jcfg and tm.net.encoder.taps == (4, 5, 6, 7)
    frame = _frame(3)
    assert _abs_rel(tm.inference(frame, 56).numpy(), np.asarray(jm.inference(frame, 56))) <= ABS_REL_BUDGET


def test_v1_ignores_the_metric_file_name(tmp_path):
    """V1 has no metric head: a "metric" file name does not make one."""
    path = _save(random_original_depth_anything_state_dict(CONFIGS["v1"], seed=SEED), tmp_path / "depth_anything_v1_metric.pth")
    jcfg, _ = jax_make_dpt(path)
    cfg, tm = make_dpt_from_state_dict(path, device=DEVICE)
    assert cfg == jcfg and not cfg["is_metric"] and not tm.net.head.is_metric


def test_metric_giant_matches_jax(tmp_path):
    path = _save(random_original_depth_anything_state_dict(CONFIGS["giant"], seed=SEED), tmp_path / "depth_anything_v2_metric_vitg.pth")
    jcfg, jm = jax_make_dpt(path)
    cfg, tm = make_dpt_from_state_dict(path, device=DEVICE)
    assert cfg == jcfg and cfg["is_metric"] and cfg["is_giant"]
    got = tm.inference(_frame(4), 56).numpy()
    assert got.min() > 0.0 and got.max() < 1.0
    assert _abs_rel(got, np.asarray(jm.inference(_frame(4), 56))) <= ABS_REL_BUDGET


@pytest.mark.parametrize("version", [1, 2])
def test_random_builder_matches_jax_random_builder(version):
    kwargs = dict(features_per_token=64, num_heads=1, num_blocks=8, reassembly_features_list=(8, 16, 32, 64),
                  base_patch_grid_hw=(8, 8), fusion_channels=16)
    if version == 1:
        jm, tm = jax_make_random_v1(**kwargs, dtype=jnp.float32, seed=3), make_depthanythingv1_dpt(**kwargs, seed=3, device=DEVICE)
    else:
        kwargs = dict(kwargs, num_blocks=4, is_giant=True)
        jm, tm = jax_make_random_v2(**kwargs, dtype=jnp.float32, seed=3), make_depthanythingv2_dpt(**kwargs, seed=3, device=DEVICE)
    frame = _frame(5)
    assert _abs_rel(tm.inference(frame, 112).numpy(), np.asarray(jm.inference(frame, 112))) <= ABS_REL_BUDGET


def test_kernels_plain_versions_equal_the_models_own_layers(models):
    """What chip_smoke.py holds the two kernels against on the card, here
    with their plain versions on the V1 model's own tensors: a block's
    mlp_residual on the residual stream after its attention (the block's
    input captured by a forward pre-hook, then its attention half), and the
    head's tail on its input (captured by wrapping Head.tail)."""
    _, (_, tm) = models["v1"]
    net, captured = tm.net, {}
    hooks = [net.encoder.blocks[i].register_forward_pre_hook(lambda m, args, i=i: captured.__setitem__(i, args[0]))
             for i in (0, 7)]
    tail = net.head.tail
    net.head.tail = lambda x: tail(captured.setdefault("head", x))
    try:
        with torch.inference_mode():
            tm.forward(tm.prepare_image_bgr(_frame(6), 112))
    finally:
        del net.head.tail
        for hook in hooks:
            hook.remove()
    with torch.inference_mode():
        for i in (0, 7):
            block = net.encoder.blocks[i]
            tokens = block.attention_residual(captured[i])
            n2, m = block.norm2, block.mlp
            got = fused_ln_mlp_residual(tokens, n2.weight, n2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias, block.ls2)
            torch.testing.assert_close(got, block.mlp_residual(tokens), rtol=1e-5, atol=1e-5)
        head, hx = net.head, captured["head"]
        assert tuple(hx.shape) == (1, 8, 112, 112)
        got = fused_head_tail(hx, head.conv_mid.weight, head.conv_mid.bias, head.proj.weight, head.proj.bias, head.is_metric)
        torch.testing.assert_close(got, head.tail(hx), rtol=1e-5, atol=1e-6)
