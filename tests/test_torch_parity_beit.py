"""MiDaS v3.1 BEiT end to end: the PyTorch port against the JAX package on
the same tiny original-format checkpoint, in float32 on the CPU.

Config: F=128 (2 heads x 64), 4 blocks, reassembly (16, 24, 32, 40),
fusion 16, patch 16, base grid 6x6. On CPU tensors the port's attention runs
the kernel's plain version; the JAX package runs XLA attention. The repo's
f32 parity budget is 1e-3 mean abs-rel; the two packages differ only in
float32 summation order, measured ~1e-7 here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.checkpoints.beit import convert_state_dict as jax_convert_state_dict
from muggled_dpt_tpu.checkpoints.beit import random_original_state_dict as jax_random_state_dict
from muggled_dpt_tpu.make_beit_dpt import make_beit_dpt as jax_make_random
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu.models.beit import compute_bias_stack as jax_compute_bias_stack
from muggled_dpt_tpu.models.beit import relative_position_index as jax_relative_position_index
from muggled_dpt_tpu_torch import make_beit_dpt, make_dpt_from_state_dict
from muggled_dpt_tpu_torch.checkpoints.beit import convert_state_dict, get_config_from_state_dict, random_original_state_dict
from muggled_dpt_tpu_torch.checkpoints.from_jax import beit_params_from_jax
from muggled_dpt_tpu_torch.models.beit import compute_bias_stack, relative_position_index
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

CFG = {
    "features_per_token": 128,
    "num_blocks": 4,
    "num_heads": 2,
    "reassembly_features_list": [16, 24, 32, 40],
    "fusion_channels": 16,
    "patch_size_px": 16,
    "base_patch_grid_hw": (6, 6),
}
SEED = 5
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
ABS_REL_BUDGET = 1e-3


def _abs_rel(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).mean() / (np.abs(ref).mean() + 1e-12))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = random_original_state_dict(CFG, seed=SEED)
    path = tmp_path_factory.mktemp("ckpt") / "dpt_beit_tiny_512.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def models(ckpt):
    return jax_make_dpt(ckpt)[1], make_dpt_from_state_dict(ckpt, device=DEVICE)[1]


def _frame(seed, hw=(120, 160)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


def test_random_state_dict_is_byte_identical():
    ours = random_original_state_dict(CFG, seed=SEED)
    theirs = jax_random_state_dict(CFG, seed=SEED)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k


def test_beit_params_from_jax_equals_own_conversion():
    sd = random_original_state_dict(CFG, seed=SEED)
    cfg = get_config_from_state_dict(sd)
    ours = convert_state_dict(sd, cfg)
    theirs = beit_params_from_jax(jax_convert_state_dict(sd, cfg))
    assert set(ours) == set(theirs)
    assert not any("relative_position_index" in k for k in ours)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        assert torch.equal(ours[k], theirs[k]), k


def test_config_matches_jax(ckpt):
    jcfg, _ = jax_make_dpt(ckpt)
    cfg, model = make_dpt_from_state_dict(ckpt, device=DEVICE)
    assert cfg == jcfg
    assert cfg["num_heads"] == 2 and cfg["base_patch_grid_hw"] == (6, 6)
    assert model.default_size_px == 96 and model.tiling_size == 32


def test_relative_position_index_matches_documented_example():
    """The 2x3-grid example of the reference (tests/test_parity_beit.py:34-50)."""
    expected = np.array(
        [
            [17, 15, 15, 15, 15, 15, 15],
            [16, 7, 6, 5, 2, 1, 0],
            [16, 8, 7, 6, 3, 2, 1],
            [16, 9, 8, 7, 4, 3, 2],
            [16, 12, 11, 10, 7, 6, 5],
            [16, 13, 12, 11, 8, 7, 6],
            [16, 14, 13, 12, 9, 8, 7],
        ],
        dtype=np.int32,
    )
    np.testing.assert_array_equal(relative_position_index((2, 3)), expected)


@pytest.mark.parametrize("grid", [(1, 1), (6, 6), (9, 7), (3, 11)])
def test_relative_position_index_matches_jax(grid):
    """The port builds the index from aranges on the device; the JAX package
    in numpy on the host. Same int32 matrix."""
    got = relative_position_index(grid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_relative_position_index(grid))


@pytest.mark.parametrize("base,grid", [((6, 6), (6, 6)), ((6, 6), (9, 7)), ((4, 4), (5, 5))])
@pytest.mark.parametrize("pad_to", [None, 128])
def test_compute_bias_stack_matches_jax(base, grid, pad_to):
    """The port's resize + index gather against the JAX package's resize +
    one-hot Toeplitz matmuls, with and without zero padding. The gather is
    exact; a rescaled LUT differs by float32 rounding of the two bilinear
    resizes (torch's interpolate vs the JAX package's weight matrices), the
    1e-5 of tests/test_torch_ops.py."""
    layers, heads = 3, 2
    rows = (2 * base[0] - 1) * (2 * base[1] - 1) + 3
    lut = np.random.default_rng(0).standard_normal((layers, rows, heads)).astype(np.float32)
    got = compute_bias_stack(torch.from_numpy(lut), base, grid, pad_to=pad_to).numpy()
    want = np.asarray(jax_compute_bias_stack(jnp.asarray(lut), base, grid, pad_to=pad_to))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("enable_cache", [True, False])
@pytest.mark.parametrize("side,square", [(96, True), (128, True), (160, False)])
def test_inference_matches_jax(models, side, square, enable_cache):
    jm, tm = models
    jm.config["enable_cache"] = tm.config["enable_cache"] = enable_cache
    tm.clear_cache()
    frame = _frame(1)
    want = np.asarray(jm.inference(frame, side, square))
    before = fa.launch_counts()
    got = tm.inference(frame, side, square)
    assert fa.launch_counts() == before  # CPU: the plain version, no launch
    hw = tm.compute_scaled_hw(frame.shape[:2], side, square)
    assert tuple(got.shape) == want.shape == (1, *hw)
    grid = (hw[0] // 16, hw[1] // 16)
    assert (tm._aux_cache.get(grid) is not None) == enable_cache
    assert _abs_rel(got.numpy(), want) <= ABS_REL_BUDGET
    jm.config["enable_cache"] = tm.config["enable_cache"] = True


def test_forward_and_prepare_match_jax(models):
    jm, tm = models
    frame = _frame(2)
    jx = np.asarray(jm.prepare_image_bgr(frame, 128))
    tx = tm.prepare_image_bgr(frame, 128)
    assert tuple(tx.shape) == jx.shape == (1, 3, 128, 128)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-5, atol=1e-5)
    assert _abs_rel(tm.forward(tx).numpy(), np.asarray(jm.forward(jx))) <= ABS_REL_BUDGET


def test_prepare_image_bgr_takes_interpolation_mode(models):
    _, tm = models
    frame = _frame(3)
    torch.testing.assert_close(tm.prepare_image_bgr(frame, 96, interpolation_mode="bilinear"), tm.prepare_image_bgr(frame, 96))
    with pytest.raises(ValueError, match="bilinear"):
        tm.prepare_image_bgr(frame, 96, interpolation_mode="bicubic")


@pytest.mark.parametrize("enable_cache", [True, False])
def test_plain_attention_path_matches_kernel_path(ckpt, models, enable_cache):
    _, tm = models
    _, plain = make_dpt_from_state_dict(ckpt, enable_optimizations=False, enable_cache=enable_cache, device=DEVICE)
    tm.config["enable_cache"] = enable_cache
    frame = _frame(4)
    assert _abs_rel(plain.inference(frame, 128).numpy(), tm.inference(frame, 128).numpy()) <= 1e-5
    tm.config["enable_cache"] = True


def test_batched_inference_matches_single():
    """The batched contract of tests/test_batched_inference.py:69-76: the
    per-grid bias broadcasts over the batch; duplicate frames are bit-equal."""
    m = make_beit_dpt(128, 2, 4, (16, 24, 32, 40), (6, 6), 16, device=DEVICE)
    rng = np.random.default_rng(1)
    frames = [np.ascontiguousarray(rng.integers(0, 256, (120, 160, 3), np.uint8)) for _ in range(2)]
    hw = m.compute_scaled_hw(frames[0].shape[:2], 96, True)
    singles = [m.inference_rgb_device(torch.from_numpy(f), hw)[0].numpy() for f in frames]
    batched = m.inference_rgb_device(torch.from_numpy(np.stack(frames + [frames[0]])), hw).numpy()
    assert batched.shape == (3, *singles[0].shape)
    np.testing.assert_array_equal(batched[0], batched[2])
    for i, s in enumerate(singles):
        # batch shape changes the CPU kernels' reduction tiling, as in the JAX test
        np.testing.assert_allclose(batched[i], s, rtol=5e-3, atol=5e-3)


def test_random_builder_matches_jax_random_builder():
    kwargs = dict(features_per_token=128, num_heads=2, num_blocks=4, reassembly_features_list=(16, 24, 32, 40),
                  base_patch_grid_hw=(6, 6), fusion_channels=16)
    jm = jax_make_random(**kwargs, dtype=jnp.float32, seed=2)
    tm = make_beit_dpt(**kwargs, seed=2, device=DEVICE)
    frame = _frame(6)
    assert _abs_rel(tm.inference(frame, 128).numpy(), np.asarray(jm.inference(frame, 128))) <= ABS_REL_BUDGET


def test_bf16_model_serves_finite_depth(models):
    _, tm = models
    half = tm.to(torch.bfloat16)
    depth = half.inference(_frame(7), 96)
    assert depth.dtype == torch.bfloat16 and bool(torch.isfinite(depth).all())
    assert next(iter(half._aux_cache.values())).dtype == torch.bfloat16  # the stack in the model's dtype
