"""Introspection (``DPTModel.forward_with_internals``) of the PyTorch port
against the JAX package's, on the same tiny original-format checkpoints, in
float32 on the CPU: DA-V2, DA-V1 (taps on the last 4 blocks), a toy
ViT-Giant (SwiGLU), BEiT and SwinV2, each of the last two with the per-grid
aux cached and built inline. Both packages feed the same normalized BCHW
array. Capture runs the plain attention with explicit float32 softmax
weights in both packages, whatever the model's kernels.

Budgets: depth mean abs-rel 1e-3 (the repo's f32 budget; measured ~1e-7);
attention weights 1e-5 absolute; block tokens, reassembly maps (the JAX
package's NHWC maps transposed to the port's NCHW) and the fused map 1e-4 of
the reference's largest magnitude. Also: the capture against the port's own
forward, the layouts, capture on the int8 tier (as
tests/test_quant_int8.py:52-55), ``ModelOutputCapture`` and a family
without capture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muggled_dpt_tpu.checkpoints.beit import random_original_state_dict as jax_random_beit
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu_torch import DPTModel, make_dpt_from_state_dict
from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as random_beit
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2
from muggled_dpt_tpu_torch.demo_helpers.model_capture import ModelOutputCapture
from muggled_dpt_tpu_torch.models.swinv2 import stage_grids, window_plan

DA = {
    "features_per_token": 64,
    "reassembly_features_list": [8, 16, 32, 64],
    "fusion_channels": 16,
    "patch_size_px": 14,
    "base_patch_grid_hw": (8, 8),
}
BEIT = {"features_per_token": 128, "num_blocks": 4, "num_heads": 2, "reassembly_features_list": [16, 24, 32, 40],
        "fusion_channels": 16, "patch_size_px": 16, "base_patch_grid_hw": (6, 6)}
SWIN = {"features_per_stage": [16, 32, 64, 128], "heads_per_stage": [2, 4, 4, 8], "layers_per_stage": [2, 2, 4, 2],
        "base_patch_grid_hw": (16, 16), "window_size_hw": (4, 4), "pretrained_window_sizes_per_stage": [None] * 4,
        "fusion_channels": 16, "patch_size_px": 4}
# name -> (state dict maker, config, file name, enable_cache, input (H, W))
CASES = {
    "da_v2": (random_original_depth_anything_state_dict, dict(DA, num_blocks=4), "depth_anything_v2_tiny.pth", True, (112, 140)),
    "da_v1": (random_original_depth_anything_state_dict, dict(DA, num_blocks=8), "depth_anything_v1_tiny.pth", True, (84, 112)),
    "giant": (random_original_depth_anything_state_dict, dict(DA, num_blocks=4, is_giant=True),
              "depth_anything_v2_vitg_tiny.pth", True, (112, 84)),
    "beit_cached": (random_beit, BEIT, "dpt_beit_tiny_384.pt", True, (128, 96)),
    "beit_inline": (random_beit, BEIT, "dpt_beit_tiny_384.pt", False, (128, 96)),
    "swinv2_cached": (random_swinv2, SWIN, "dpt_swin2_tiny_256.pt", True, (128, 96)),
    "swinv2_inline": (random_swinv2, SWIN, "dpt_swin2_tiny_256.pt", False, (128, 96)),
}
SEED = 17
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
ABS_REL_BUDGET = 1e-3
WEIGHTS_MAX_ABS = 1e-5
MAP_REL_MAX = 1e-4


def _abs_rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).mean() / (np.abs(ref).mean() + 1e-12))


def _close_rel_max(ours, ref, what):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err, top = float(np.abs(ours - ref).max()), float(np.abs(ref).max())
    assert err <= MAP_REL_MAX * top, (what, err, top)


def _jax_capture(jm, x):
    """JAX ``DPTModel.forward_with_internals`` (``dpt.py:261-270``) under one
    jit: eager, each op compiles on its own, about 3x slower on the CPU."""
    x = jnp.asarray(x).transpose(0, 2, 3, 1)
    p = jm.patch_size_px
    aux = jm._get_aux((x.shape[1] // p, x.shape[2] // p))
    return jax.jit(jm.spec["forward_capture"])(jm.params, x, aux)


def _input(hw, seed=3):
    return np.random.default_rng(seed).standard_normal((1, 3, *hw)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the port's model, its capture and the JAX capture on the same input."""
    root = tmp_path_factory.mktemp("capture")
    out = {}
    for name, (make_sd, cfg, file_name, enable_cache, hw) in CASES.items():
        path = str(root / file_name)
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in make_sd(cfg, seed=SEED).items()}, path)
        _, jm = jax_make_dpt(path, enable_cache=enable_cache)
        _, tm = make_dpt_from_state_dict(path, enable_cache=enable_cache, device=DEVICE)
        x = _input(hw)
        jdepth, jint = _jax_capture(jm, x)
        depth, internals = tm.forward_with_internals(torch.from_numpy(x))
        out[name] = (tm, x, depth, internals, np.asarray(jdepth), jint)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_depth_matches_jax(runs, name):
    _, _, depth, _, jdepth, _ = runs[name]
    assert tuple(depth.shape) == jdepth.shape
    assert _abs_rel(depth.numpy(), jdepth) <= ABS_REL_BUDGET


@pytest.mark.parametrize("name", list(CASES))
def test_attention_weights_match_jax(runs, name):
    _, _, _, internals, _, jint = runs[name]
    assert len(internals["attention"]) == len(jint["attention"])
    for i, (w, jw) in enumerate(zip(internals["attention"], jint["attention"])):
        jw = np.asarray(jw)
        assert w.dtype == torch.float32 and tuple(w.shape) == jw.shape, (i, w.shape, jw.shape)
        assert float(np.abs(w.numpy() - jw).max()) <= WEIGHTS_MAX_ABS, i


@pytest.mark.parametrize("name", list(CASES))
def test_block_tokens_match_jax(runs, name):
    _, _, _, internals, _, jint = runs[name]
    assert len(internals["block_tokens"]) == len(jint["block_tokens"])
    for i, (t, jt) in enumerate(zip(internals["block_tokens"], jint["block_tokens"])):
        _close_rel_max(t.numpy(), jt, f"block {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_maps_match_jax_transposed(runs, name):
    """The port keeps NCHW maps; the JAX package's are NHWC."""
    _, _, _, internals, _, jint = runs[name]
    assert len(internals["reassembly_maps"]) == 4
    for i, (m, jm) in enumerate(zip(internals["reassembly_maps"], jint["reassembly_maps"])):
        _close_rel_max(m.numpy(), np.asarray(jm).transpose(0, 3, 1, 2), f"reassembly map {i}")
    _close_rel_max(internals["fused_map"].numpy(), np.asarray(jint["fused_map"]).transpose(0, 3, 1, 2), "fused map")


@pytest.mark.parametrize("name", list(CASES))
def test_capture_depth_matches_own_forward(runs, name):
    tm, x, depth, _, _, _ = runs[name]
    assert _abs_rel(depth.numpy(), tm.forward(torch.from_numpy(x)).numpy()) <= ABS_REL_BUDGET


@pytest.mark.parametrize("name", list(CASES))
def test_internals_layout(runs, name):
    """One token tensor and one float32 softmax map per block; rows sum to 1."""
    tm, x, depth, internals, _, _ = runs[name]
    h, w = x.shape[2:]
    cfg = CASES[name][1]
    if name.startswith("swinv2"):
        grids = stage_grids((h // 4, w // 4))
        want_tokens, want_attn = [], []
        for s, grid in enumerate(grids):
            (wh, ww), _ = window_plan(grid, cfg["window_size_hw"])
            nw, area = (grid[0] // wh) * (grid[1] // ww), wh * ww
            want_tokens += [(1, grid[0] * grid[1], cfg["features_per_stage"][s])] * cfg["layers_per_stage"][s]
            want_attn += [(1, nw, cfg["heads_per_stage"][s], area, area)] * cfg["layers_per_stage"][s]
    else:
        p, f = cfg["patch_size_px"], cfg["features_per_token"]
        n = (h // p) * (w // p) + 1
        heads = cfg.get("num_heads", f // 64)
        want_tokens = [(1, n, f)] * cfg["num_blocks"]
        want_attn = [(1, heads, n, n)] * cfg["num_blocks"]
    assert [tuple(t.shape) for t in internals["block_tokens"]] == want_tokens
    assert [tuple(a.shape) for a in internals["attention"]] == want_attn
    for a in internals["attention"]:
        assert a.dtype == torch.float32
        torch.testing.assert_close(a.sum(-1), torch.ones(a.shape[:-1]), rtol=0, atol=1e-5)
    assert tuple(depth.shape) == (1, h, w)
    assert internals["fused_map"].shape[:2] == (1, cfg["fusion_channels"])
    assert set(internals) == {"block_tokens", "attention", "reassembly_maps", "fused_map"}


def test_beit_cached_stack_is_padded_and_sliced(runs):
    """The cached stack's rows are padded past N; capture slices them off."""
    tm, x, _, internals, _, _ = runs["beit_cached"]
    grid = (x.shape[2] // 16, x.shape[3] // 16)
    n = grid[0] * grid[1] + 1
    stack = tm._aux_cache[grid]
    assert stack.shape[-1] > n and internals["attention"][0].shape[-1] == n


def test_capture_ignores_use_kernel(runs):
    """A model whose blocks send attention through the kernel captures all the same."""
    tm, *_ = runs["da_v2"]
    assert all(block.use_kernel for block in tm.net.encoder.blocks)
    plain = DPTModel(tm.net, tm.config, tm.spec)
    for block in plain.net.encoder.blocks:
        block.use_kernel = False
    x = torch.from_numpy(_input((112, 140)))
    try:
        d_plain, i_plain = plain.forward_with_internals(x)
    finally:
        for block in plain.net.encoder.blocks:
            block.use_kernel = True
    d_kernel, i_kernel = tm.forward_with_internals(x)
    assert torch.equal(d_plain, d_kernel)
    assert all(torch.equal(a, b) for a, b in zip(i_plain["attention"], i_kernel["attention"]))


def test_capture_in_bfloat16_keeps_float32_weights(runs):
    tm, x, depth, internals, _, _ = runs["beit_cached"]
    bf16 = tm.to(torch.bfloat16)
    d16, i16 = bf16.forward_with_internals(torch.from_numpy(x))
    assert d16.dtype == torch.bfloat16 and i16["block_tokens"][0].dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in i16["attention"])
    assert _abs_rel(d16.float().numpy(), depth.numpy()) < 5e-2


@pytest.mark.parametrize("is_giant,include_qkv", [(False, False), (False, True), (True, False)])
def test_capture_on_int8_tier(tmp_path, is_giant, include_qkv):
    """As tests/test_quant_int8.py:52-55: capture runs on the quantized
    model (its qkv and proj through ``linear_p``), and its depth stays with
    the tier's own forward."""
    from muggled_dpt_tpu_torch import make_depthanythingv2_dpt
    from muggled_dpt_tpu_torch.ops.quant import QuantLinear

    m = make_depthanythingv2_dpt(64, 2, 4, (8, 16, 32, 64), (8, 8), 16, is_giant=is_giant, device=DEVICE)
    q = m.quantize_encoder_int8(include_qkv=include_qkv)
    assert isinstance(q.net.encoder.blocks[0].attn.qkv, QuantLinear) == include_qkv
    img = np.random.default_rng(0).integers(0, 256, (120, 160, 3), np.uint8)
    bchw = q.prepare_image_bgr(img)
    depth, internals = q.forward_with_internals(bchw)
    assert len(internals["attention"]) == 4
    d0, d1 = m.forward(bchw).numpy(), q.forward(bchw).numpy()
    assert _abs_rel(d1, d0) < 1e-2
    assert _abs_rel(depth.numpy(), d1) < 1e-2


def test_capture_on_int8_beit_with_neck(runs):
    tm, x, *_ = runs["beit_inline"]
    q = tm.quantize_encoder_int8(include_qkv=True, include_neck=True)
    depth, internals = q.forward_with_internals(torch.from_numpy(x))
    assert len(internals["attention"]) == BEIT["num_blocks"] and bool(torch.isfinite(depth).all())
    assert _abs_rel(depth.numpy(), q.forward(torch.from_numpy(x)).numpy()) < 1e-2


@pytest.mark.parametrize("target", ["attention", "block_tokens", "reassembly_maps", "fused_map"])
def test_model_output_capture(runs, target):
    tm, x, depth, internals, _, _ = runs["da_v1"]
    cap = ModelOutputCapture(tm, target)
    got_depth = cap.run(torch.from_numpy(x))
    assert isinstance(got_depth, np.ndarray) and np.array_equal(got_depth, depth.numpy())
    want = internals[target] if isinstance(internals[target], list) else [internals[target]]
    assert len(cap) == len(want)
    for got, ref in zip(cap, want):
        assert isinstance(got, np.ndarray) and np.array_equal(got, ref.numpy())
    assert cap[0] is cap.results[0]


def test_family_without_capture_raises(runs):
    tm, x, *_ = runs["da_v2"]
    spec = {k: v for k, v in tm.spec.items() if k != "forward_capture"}
    with pytest.raises(NotImplementedError):
        DPTModel(tm.net, tm.config, spec).forward_with_internals(torch.from_numpy(x))


def test_capture_checks_its_input(runs):
    tm, *_ = runs["da_v2"]
    with pytest.raises(ValueError):
        tm.forward_with_internals(torch.zeros(1, 3, 100, 140))


def test_beit_state_dicts_are_the_same_in_both_packages():
    ours, theirs = random_beit(BEIT, seed=SEED), jax_random_beit(BEIT, seed=SEED)
    assert list(ours) == list(theirs) and all(ours[k].tobytes() == theirs[k].tobytes() for k in ours)
