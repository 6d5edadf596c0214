"""MiDaS v3.1 SwinV2 end to end: the PyTorch port against the JAX package on
the same tiny original-format checkpoints, in float32 on the CPU, plus the
windowing machinery (window plan, shift mask, CPB bias, patch merge, block)
against the JAX functions.

Configs: the JAX package's TINY_CFG (tests/test_parity_swinv2.py:14-23;
head width 8) and a head-width-32 toy that the CUDA kernel could take:
F=(64, 128, 256, 512), H=(2, 4, 8, 16), L=(2, 2, 2, 2), grid 16, window 4,
fusion 16, patch 4. On CPU tensors the window attention runs the kernel's
plain version; the JAX package runs its einsum path. The repo's f32 parity
budget is 1e-3 mean abs-rel; the two packages differ only in float32
summation order, measured ~4e-7 here."""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.checkpoints.swinv2 import convert_state_dict as jax_convert_state_dict
from muggled_dpt_tpu.checkpoints.swinv2 import random_original_state_dict as jax_random_state_dict
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu.make_swinv2_dpt import make_swinv2_dpt as jax_make_random
from muggled_dpt_tpu.models import swinv2 as jsw
from muggled_dpt_tpu_torch import make_dpt_from_state_dict, make_swinv2_dpt
from muggled_dpt_tpu_torch.checkpoints.from_jax import swinv2_params_from_jax
from muggled_dpt_tpu_torch.checkpoints.swinv2 import convert_state_dict, get_config_from_state_dict, random_original_state_dict
from muggled_dpt_tpu_torch.models import swinv2 as sw
from muggled_dpt_tpu_torch.models.swinv2_family import SwinV2DPT
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

TINY_CFG = {
    "features_per_stage": [16, 32, 64, 128],
    "heads_per_stage": [2, 4, 4, 8],
    "layers_per_stage": [2, 2, 4, 2],
    "base_patch_grid_hw": (16, 16),
    "window_size_hw": (4, 4),
    "pretrained_window_sizes_per_stage": [None, None, None, None],
    "fusion_channels": 16,
    "patch_size_px": 4,
}
D32_CFG = {
    "features_per_stage": [64, 128, 256, 512],
    "heads_per_stage": [2, 4, 8, 16],
    "layers_per_stage": [2, 2, 2, 2],
    "base_patch_grid_hw": (16, 16),
    "window_size_hw": (4, 4),
    "pretrained_window_sizes_per_stage": [None, None, None, None],
    "fusion_channels": 16,
    "patch_size_px": 4,
}
CONFIGS = {"tiny": TINY_CFG, "d32": D32_CFG}
SEED = 21
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
ABS_REL_BUDGET = 1e-3


def _abs_rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    return float(np.abs(ours - ref).mean() / (np.abs(ref).mean() + 1e-12))


def _save(sd, path) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ckpt")
    return {name: _save(random_original_state_dict(cfg, seed=SEED), folder / f"swin2_{name}_256.pt") for name, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def jax_models(ckpts):
    return {name: jax_make_dpt(path)[1] for name, path in ckpts.items()}


def _frame(seed, hw=(150, 110)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_random_state_dict_is_byte_identical(name):
    ours = random_original_state_dict(CONFIGS[name], seed=SEED)
    theirs = jax_random_state_dict(CONFIGS[name], seed=SEED)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_swinv2_params_from_jax_equals_own_conversion(name):
    sd = random_original_state_dict(CONFIGS[name], seed=SEED)
    cfg = get_config_from_state_dict(sd)
    ours = convert_state_dict(sd, cfg)
    theirs = swinv2_params_from_jax(jax_convert_state_dict(sd, cfg))
    assert set(ours) == set(theirs)
    assert not any(s in k for k in ours for s in ("attn_mask", "relative_coords_table", "relative_position_index"))
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_conversion_of_a_tensor_state_dict(dtype):
    """A state dict of tensors in a 16-bit type (as a checkpoint saved in
    bf16 or weights made on the card arrive) converts as its float32 values
    do, the folded logit scale included."""
    sd = {k: torch.from_numpy(v).to(dtype) for k, v in random_original_state_dict(D32_CFG, seed=SEED).items()}
    cfg = get_config_from_state_dict(sd)
    ours = convert_state_dict(sd, cfg)
    theirs = convert_state_dict({k: v.float().numpy() for k, v in sd.items()}, cfg)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == torch.float32 and torch.equal(ours[k], theirs[k]), k


def test_config_and_sniffing_match_jax(ckpts, jax_models):
    cfg, model = make_dpt_from_state_dict(ckpts["tiny"], device=DEVICE)
    assert isinstance(model.net, SwinV2DPT)
    assert cfg == jax_make_dpt(ckpts["tiny"])[0]
    assert cfg["heads_per_stage"] == [2, 4, 4, 8] and tuple(cfg["window_size_hw"]) == (4, 4)
    assert model.tiling_size == 32 and model.default_size_px == 64
    # the stored buffers the converter drops: loading ignores them, as the JAX converter does
    sd = random_original_state_dict(TINY_CFG, seed=1)
    sd["pretrained.model.layers.0.blocks.0.attn.relative_coords_table"] = np.zeros((1, 7, 7, 2), np.float32)
    sd["pretrained.model.layers.0.blocks.0.attn.relative_position_index"] = np.zeros((16, 16), np.int64)
    assert set(convert_state_dict(sd, get_config_from_state_dict(sd))) == set(model.net.state_dict())


GRIDS = [(16, 16), (8, 8), (7, 9), (10, 14), (3, 3), (12, 20), (5, 25)]


@pytest.mark.parametrize("target", [(4, 4), (6, 6), (16, 16), (5, 5), (24, 24)])
def test_window_plan_matches_jax(target):
    for grid in GRIDS + [(96, 96), (128, 128), (48, 48), (12, 12), (16, 8)]:
        assert sw.window_plan(grid, target) == jsw.window_plan(grid, target), (grid, target)


@pytest.mark.parametrize(
    "grid,win,shift",
    [((16, 16), (4, 4), (2, 2)), ((12, 20), (4, 4), (2, 2)), ((8, 8), (4, 8), (2, 4)), ((4, 12), (4, 4), (0, 2)),
     ((96, 96), (24, 24), (12, 12)), ((16, 16), (4, 4), (0, 0))],
)
def test_shift_mask_matches_jax(grid, win, shift):
    want = jsw.shift_mask_np(grid, win, shift)
    got = sw.shift_mask(grid, win, shift)
    if want is None:
        assert got is None
        return
    assert got.dtype == torch.float32 and set(np.unique(got.numpy())) <= {0.0, -100.0}
    np.testing.assert_array_equal(got.numpy(), want)


def _random_block(features, heads, seed, small=1.0):
    """A port SwinBlock and the JAX block dict on the same numpy weights;
    ``small`` scales the proj and fc2 weights (so the post-norms see small
    variances, where their eps matters)."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    c = features
    raw = {
        "qkv.weight": w(3 * c, c), "q_bias": w(c), "v_bias": w(c), "proj.weight": w(c, c, scale=0.1 * small),
        "proj.bias": w(c, scale=0.1 * small), "logit_scale": np.exp(w(heads) + np.log(10.0)).astype(np.float32),
        "cpb0.weight": w(512, 2, scale=0.5), "cpb0.bias": w(512), "cpb1.weight": w(heads, 512),
        "norm1.weight": 1 + w(c), "norm1.bias": w(c), "norm2.weight": 1 + w(c), "norm2.bias": w(c),
        "fc1.weight": w(4 * c, c), "fc1.bias": w(4 * c), "fc2.weight": w(c, 4 * c, scale=0.1 * small),
        "fc2.bias": w(c, scale=0.1 * small),
    }
    block = sw.SwinBlock(c, heads)
    sd = {k: torch.from_numpy(v) for k, v in raw.items() if k not in ("q_bias", "v_bias")}
    sd["qkv.bias"] = torch.from_numpy(np.concatenate([raw["q_bias"], np.zeros_like(raw["q_bias"]), raw["v_bias"]]))
    block.load_state_dict(sd)
    bp = {f"{k.split('.')[0]}_kernel": raw[k].T for k in ("qkv.weight", "proj.weight", "cpb0.weight", "cpb1.weight",
                                                           "fc1.weight", "fc2.weight")}
    bp.update({f"{k}_bias": raw[f"{k}.bias"] for k in ("proj", "cpb0", "fc1", "fc2")})
    bp.update({f"{n}_scale": raw[f"{n}.weight"] for n in ("norm1", "norm2")})
    bp.update({f"{n}_bias": raw[f"{n}.bias"] for n in ("norm1", "norm2")})
    bp.update({"q_bias": raw["q_bias"], "v_bias": raw["v_bias"], "logit_scale": raw["logit_scale"]})
    return block, {k: jnp.asarray(v) for k, v in bp.items()}


@pytest.mark.parametrize("window,pws", [((4, 6), 8), ((4, 6), None), ((5, 5), None), ((24, 24), 12)])
def test_cpb_bias_matches_jax(window, pws):
    block, bp = _random_block(16, 3, seed=2)
    want = np.asarray(jsw.cpb_bias(bp, window, pws))
    with torch.no_grad():
        got = sw.cpb_bias(block, window, pws)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, window[0] * window[1], window[0] * window[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(sw.cpb_index(window).numpy(), jsw.cpb_index_np(window))
    # torch's and numpy's float32 log2 may differ by an ulp
    np.testing.assert_allclose(sw.cpb_coords_table(window, pws).numpy(), jsw.cpb_coords_table_np(window, pws), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shift_block", [False, True])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_block_matches_jax(shift_block, use_kernel):
    """Post-norm order, roll direction, cosine attention and eps 1e-5: the
    small proj/fc2 weights leave the post-norms' inputs at a variance where
    eps 1e-6 would differ well above the tolerance."""
    c, heads, grid, target = 64, 2, (8, 12), (4, 4)
    block, bp = _random_block(c, heads, seed=4, small=1e-2)
    block.use_kernel = use_kernel
    x = np.random.default_rng(5).standard_normal((2, *grid, c)).astype(np.float32)
    bp["_pretrained_window_size"] = None
    want = np.asarray(jsw.block_forward(jnp.asarray(x), bp, heads, grid, target, shift_block))
    window_hw, shift_hw = sw.window_plan(grid, target)
    mask = sw.shift_mask(grid, window_hw, shift_hw) if shift_block else None
    with torch.no_grad():
        got = block(torch.from_numpy(x), window_hw, shift_hw if shift_block else (0, 0), sw.cpb_bias(block, window_hw, None), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_patch_merge_matches_jax():
    """Concat order tl, bl, tr, br; eps 1e-5 (a small input variance makes it count)."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 8, 12, 16)) * 1e-3).astype(np.float32)
    w, g, b = rng.standard_normal((32, 64)).astype(np.float32) * 0.1, 1 + rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    merge = sw.PatchMerge(16, 32)
    merge.load_state_dict({"reduction.weight": torch.from_numpy(w), "norm.weight": torch.from_numpy(g), "norm.bias": torch.from_numpy(b)})
    want = np.asarray(jsw.patch_merge(jnp.asarray(x), {"reduction_kernel": w.T, "norm_scale": g, "norm_bias": b}))
    with torch.no_grad():
        got = merge(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cosine_normalize_is_rsqrt_with_eps():
    """x * rsqrt(sum(x^2) + 1e-12), not F.normalize's clamp of the norm: the
    two differ on rows of tiny norm."""
    x = torch.tensor([[3.0, 4.0], [1e-7, 0.0], [0.0, 0.0]])
    want = x.double() / torch.sqrt((x.double() ** 2).sum(-1, keepdim=True) + 1e-12)
    torch.testing.assert_close(sw.cosine_normalize(x).double(), want, rtol=1e-6, atol=1e-9)
    assert not torch.allclose(sw.cosine_normalize(x), torch.nn.functional.normalize(x, dim=-1))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cpb_stack_matches_jax(ckpts, jax_models, name):
    """The per-grid aux: stage s's (L, H, A, A) stack holds block 2i at pair
    i's b0 and block 2i+1 at its b1 of the JAX stack; the masks are the JAX
    shift masks of the stages that shift."""
    jm = jax_models[name]
    _, tm = make_dpt_from_state_dict(ckpts[name], device=DEVICE)
    grid = (24, 16)
    want = jsw.compute_cpb_stack(jm.params["encoder"], grid, jm.spec["encoder_config"])
    with torch.inference_mode():
        got = tm.spec["make_aux"](tm.net, grid, torch.float32)
    for s, (stage, jstage) in enumerate(zip(got, want)):
        j = np.stack([np.asarray(jstage["b0"]), np.asarray(jstage["b1"])], axis=1)  # (P, 2, H, A, A)
        np.testing.assert_allclose(stage["cpb"].numpy(), j.reshape(-1, *j.shape[2:]), rtol=1e-6, atol=1e-6)
        g = (grid[0] >> s, grid[1] >> s)
        window_hw, shift_hw = jsw.window_plan(g, CONFIGS[name]["window_size_hw"])
        jmask = jsw.shift_mask_np(g, window_hw, shift_hw)
        assert (stage["mask"] is None) == (jmask is None)
        if jmask is not None:
            np.testing.assert_array_equal(stage["mask"].numpy(), jmask)


@pytest.mark.parametrize("enable_cache", [True, False])
@pytest.mark.parametrize("enable_optimizations", [True, False])
@pytest.mark.parametrize("side,square", [(64, True), (96, False)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_inference_matches_jax(ckpts, jax_models, name, side, square, enable_optimizations, enable_cache):
    jm = jax_models[name]
    _, tm = make_dpt_from_state_dict(ckpts[name], enable_optimizations=enable_optimizations, enable_cache=enable_cache, device=DEVICE)
    jm.config["enable_cache"] = enable_cache
    frame = _frame(17)
    want = np.asarray(jm.inference(frame, side, square))
    before = fa.launch_counts()
    got = tm.inference(frame, side, square)
    assert fa.launch_counts() == before  # CPU: the plain version, no launch
    hw = tm.compute_scaled_hw(frame.shape[:2], side, square)
    assert tuple(got.shape) == want.shape == (1, *hw)
    assert (tm._aux_cache.get((hw[0] // 4, hw[1] // 4)) is not None) == enable_cache
    assert _abs_rel(got.numpy(), want) <= ABS_REL_BUDGET
    jm.config["enable_cache"] = True


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cache_equals_no_cache_and_kernel_route_equals_plain(ckpts, name):
    frame = _frame(3, (130, 170))
    depths = {}
    for opt in (True, False):
        for cache in (True, False):
            _, m = make_dpt_from_state_dict(ckpts[name], enable_optimizations=opt, enable_cache=cache, device=DEVICE)
            depths[opt, cache] = m.inference(frame, 96, False).numpy()
    for key, depth in depths.items():
        np.testing.assert_allclose(depth, depths[True, True], rtol=1e-5, atol=1e-5, err_msg=str(key))


def test_batched_inference_matches_single():
    """The batched contract of tests/test_batched_inference.py:79-88: windows
    are carved per image, so the shift masks stay image-local; duplicate
    frames are bit-equal."""
    m = make_swinv2_dpt((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16, device=DEVICE)
    rng = np.random.default_rng(1)
    frames = [np.ascontiguousarray(rng.integers(0, 256, (120, 160, 3), np.uint8)) for _ in range(2)]
    hw = m.compute_scaled_hw(frames[0].shape[:2], 64, True)
    singles = [m.inference_rgb_device(torch.from_numpy(f), hw)[0].numpy() for f in frames]
    batched = m.inference_rgb_device(torch.from_numpy(np.stack(frames + [frames[0]])), hw).numpy()
    assert batched.shape == (3, *singles[0].shape)
    np.testing.assert_array_equal(batched[0], batched[2])
    for i, s in enumerate(singles):
        # batch shape changes the CPU kernels' reduction tiling, as in the JAX test
        np.testing.assert_allclose(batched[i], s, rtol=5e-3, atol=5e-3)


def test_random_factory_matches_jax_random_factory():
    args = ((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16)
    jm = jax_make_random(*args, dtype=jnp.float32, seed=2)
    tm = make_swinv2_dpt(*args, seed=2, device=DEVICE)
    frame = _frame(6)
    assert _abs_rel(tm.inference(frame, 64).numpy(), np.asarray(jm.inference(frame, 64))) <= ABS_REL_BUDGET


def test_bf16_model_serves_finite_depth_with_aux_in_its_dtype(ckpts):
    _, tm = make_dpt_from_state_dict(ckpts["d32"], dtype=torch.bfloat16, device=DEVICE)
    depth = tm.inference(_frame(7), 64)
    assert depth.dtype == torch.bfloat16 and bool(torch.isfinite(depth).all())
    aux = next(iter(tm._aux_cache.values()))
    assert all(t.dtype == torch.bfloat16 for stage in aux for t in stage.values() if t is not None)


def _live_tensors():
    gc.collect()
    return [o for o in gc.get_objects() if issubclass(type(o), torch.Tensor)]


def test_clear_cache_leaves_no_cpb_or_mask_behind(ckpts):
    """After clear_cache no CPB stack, shift mask or index of any grid the
    model served is alive: nothing outside the aux cache keeps them."""
    _, tm = make_dpt_from_state_dict(ckpts["tiny"], device=DEVICE)
    frame = _frame(8)
    for side in (64, 96, 128):
        tm.inference(frame, side)
    assert len(tm._aux_cache) == 3
    tm.clear_cache()
    area = 16  # every stage's window is 4x4 at these grids
    left = [t for t in _live_tensors()
            if not isinstance(t, torch.nn.Parameter) and t.dim() >= 2 and t.shape[-1] == area and t.shape[-2] == area]
    assert left == []
