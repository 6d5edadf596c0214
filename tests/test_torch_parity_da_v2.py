"""Depth-Anything V2 end to end: the PyTorch port (``muggled_dpt_tpu_torch``)
against the JAX package on the same tiny original-format checkpoint, in
float32 on the CPU.

Config: F=128 (2 heads x 64), 4 blocks, reassembly (16, 24, 32, 40),
fusion 16, patch 14, base grid 8x8. On CPU tensors the port's attention
runs the kernel's plain version; the JAX package runs XLA attention."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.checkpoints.depth_anything import convert_state_dict as jax_convert_state_dict
from muggled_dpt_tpu.checkpoints.random_init import (
    random_original_depth_anything_state_dict as jax_random_state_dict,
)
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_random
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu_torch import dpt as dpt_mod
from muggled_dpt_tpu_torch import make_depthanythingv2_dpt, make_dpt_from_state_dict
from muggled_dpt_tpu_torch.checkpoints.depth_anything import convert_state_dict, get_config_from_state_dict
from muggled_dpt_tpu_torch.checkpoints.from_jax import params_from_jax
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.make_dpt import load_state_dict
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

CFG = {
    "features_per_token": 128,
    "num_blocks": 4,
    "reassembly_features_list": [16, 24, 32, 40],
    "fusion_channels": 16,
    "patch_size_px": 14,
    "base_patch_grid_hw": (8, 8),
}
SEED = 5
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
# The repo's f32 parity budget (README "Numerical parity"); the two packages
# differ only in float32 summation order, measured ~1e-7 here.
ABS_REL_BUDGET = 1e-3


def _abs_rel(ours: np.ndarray, ref: np.ndarray) -> float:
    scale = float(np.abs(ref).mean()) + 1e-12
    return float(np.abs(ours - ref).mean() / scale)


def _save(sd_np: dict, path) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd_np.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = random_original_depth_anything_state_dict(CFG, seed=SEED)
    return _save(sd, tmp_path_factory.mktemp("ckpt") / "depth_anything_v2_tiny.pth")


@pytest.fixture(scope="module")
def models(ckpt):
    return jax_make_dpt(ckpt)[1], make_dpt_from_state_dict(ckpt, device=DEVICE)[1]


def _frame(seed, hw=(120, 160)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


def test_random_state_dict_is_byte_identical():
    ours = random_original_depth_anything_state_dict(CFG, seed=SEED)
    theirs = jax_random_state_dict(CFG, seed=SEED)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k


def test_params_from_jax_equals_own_conversion():
    sd = random_original_depth_anything_state_dict(CFG, seed=SEED)
    cfg = get_config_from_state_dict(sd)
    ours = convert_state_dict(sd, cfg)
    theirs = params_from_jax(jax_convert_state_dict(sd, cfg))
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        assert torch.equal(ours[k], theirs[k]), k


def test_config_matches_jax(ckpt):
    jcfg, _ = jax_make_dpt(ckpt)
    cfg, model = make_dpt_from_state_dict(ckpt, device=DEVICE)
    assert cfg == jcfg
    assert cfg["num_heads"] == 2 and cfg["base_patch_grid_hw"] == (8, 8)
    assert model.dtype == torch.float32 and model.device == torch.device("cpu")


# side 420 is 3.75x the 8x8 base grid (30x30 patches, N=901): about the
# long-N ladder's 1904/518, so the bicubic pos-embed resize runs at that ratio
@pytest.mark.parametrize("square,side", [(True, 112), (False, 140), (True, 420)])
def test_inference_matches_jax(models, square, side):
    jm, tm = models
    frame = _frame(1)
    want = np.asarray(jm.inference(frame, side, square))
    before = fa.launch_counts()["fused"]
    got = tm.inference(frame, side, square)
    assert fa.launch_counts()["fused"] == before  # CPU: the plain version, no launch
    assert tuple(got.shape) == want.shape == (1, *tm.compute_scaled_hw(frame.shape[:2], side, square))
    assert got.dtype == torch.float32
    assert _abs_rel(got.numpy(), want) <= ABS_REL_BUDGET


def test_forward_and_prepare_match_jax(models):
    jm, tm = models
    frame = _frame(2)
    jx = np.asarray(jm.prepare_image_bgr(frame, 84))
    tx = tm.prepare_image_bgr(frame, 84)
    assert tuple(tx.shape) == jx.shape == (1, 3, 84, 84)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-5, atol=1e-5)
    got = tm.forward(tx).numpy()
    assert _abs_rel(got, np.asarray(jm.forward(jx))) <= ABS_REL_BUDGET


def test_plain_attention_path_matches_kernel_path(ckpt, models):
    _, tm = models
    _, plain = make_dpt_from_state_dict(ckpt, enable_optimizations=False, device=DEVICE)
    frame = _frame(3)
    assert _abs_rel(plain.inference(frame, 112).numpy(), tm.inference(frame, 112).numpy()) <= 1e-5


@pytest.mark.parametrize("form", ["model", "state_dict", "safetensors"])
def test_wrapped_and_safetensors_checkpoints_build(tmp_path, form):
    """A checkpoint wrapped as {"model": sd} or {"state_dict": sd}, and a
    .safetensors file, build as the JAX loader builds them
    (tests/test_loader_edge_cases.py:36, :66)."""
    sd = random_original_depth_anything_state_dict(CFG, seed=SEED)
    if form == "safetensors":
        from safetensors.numpy import save_file

        path = str(tmp_path / "depth_anything_v2_tiny.safetensors")
        save_file(sd, path)
    else:
        path = str(tmp_path / "depth_anything_v2_tiny.pth")
        torch.save({form: {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    jcfg, jm = jax_make_dpt(path)
    cfg, tm = make_dpt_from_state_dict(path, device=DEVICE)
    assert cfg == jcfg
    frame = _frame(7)
    assert _abs_rel(tm.inference(frame, 112).numpy(), np.asarray(jm.inference(frame, 112))) <= ABS_REL_BUDGET


def test_container_beside_tensors_is_not_unwrapped(tmp_path):
    """The JAX predicate: a "model" entry beside tensor values is a key of
    the state dict, not a container."""
    path = str(tmp_path / "mixed.pt")
    torch.save({"model": {"a": torch.zeros(1)}, "pretrained.cls_token": torch.zeros(1, 1, 4)}, path)
    assert set(load_state_dict(path)) == {"model", "pretrained.cls_token"}


def test_metric_filename_gives_sigmoid_head(tmp_path):
    path = _save(random_original_depth_anything_state_dict(CFG, seed=SEED), tmp_path / "depth_anything_v2_metric_tiny.pth")
    jcfg, jm = jax_make_dpt(path)
    cfg, tm = make_dpt_from_state_dict(path, device=DEVICE)
    assert cfg["is_metric"] and jcfg["is_metric"]
    frame = _frame(4)
    got = tm.inference(frame, 56).numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert _abs_rel(got, np.asarray(jm.inference(frame, 56))) <= ABS_REL_BUDGET


def test_default_device_is_the_card(ckpt, monkeypatch):
    """device=None means the CUDA card: without one the entry point raises
    before it builds anything, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(dpt_mod.DPTModel, "__init__", lambda self, *a, **k: built.append(self))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dpt_from_state_dict(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_depthanythingv2_dpt(64, 1, 4, (8, 16, 32, 64), (8, 8), 16)
    assert not built


def test_verify_input_rejects_bad_shapes(models):
    _, tm = models
    assert tm.verify_input(torch.zeros(1, 3, 28, 42))
    for shape in [(3, 28, 28), (1, 4, 28, 28), (1, 3, 30, 28)]:
        with pytest.raises(ValueError):
            tm.verify_input(torch.zeros(shape))


def test_to_dtype_returns_a_copy(models):
    _, tm = models
    half = tm.to(torch.bfloat16)
    assert half.dtype == torch.bfloat16 and tm.dtype == torch.float32
    assert next(half.net.parameters()).dtype == torch.bfloat16
    assert next(tm.net.parameters()).dtype == torch.float32
    depth = half.inference(_frame(5), 56)
    assert depth.dtype == torch.bfloat16 and bool(torch.isfinite(depth).all())


def test_random_builder_matches_jax_random_builder():
    kwargs = dict(
        features_per_token=128, num_heads=2, num_blocks=4, reassembly_features_list=(16, 24, 32, 40),
        base_patch_grid_hw=(37, 37), fusion_channels=16,
    )
    jm = jax_make_random(**kwargs, dtype=jnp.float32, seed=2)
    tm = make_depthanythingv2_dpt(**kwargs, seed=2, device=DEVICE)
    frame = _frame(6)
    assert _abs_rel(tm.inference(frame, 140).numpy(), np.asarray(jm.inference(frame, 140))) <= ABS_REL_BUDGET


def test_batched_inference_matches_single():
    """The batched-serving contract of tests/test_batched_inference.py:
    a (B, H, W, 3) stack through inference_rgb_device equals B single-frame
    calls; duplicate frames in one batch are bit-equal."""
    m = make_depthanythingv2_dpt(
        features_per_token=128, num_heads=2, num_blocks=4, reassembly_features_list=(16, 24, 32, 40),
        base_patch_grid_hw=(37, 37), fusion_channels=16, device=DEVICE,
    )
    rng = np.random.default_rng(0)
    frames = [np.ascontiguousarray(rng.integers(0, 256, (120, 160, 3), np.uint8)) for _ in range(3)]
    hw = m.compute_scaled_hw(frames[0].shape[:2], 140, True)

    singles = [m.inference_rgb_device(torch.from_numpy(f), hw)[0].numpy() for f in frames]
    batched = m.inference_rgb_device(torch.from_numpy(np.stack(frames + [frames[0]])), hw).numpy()

    assert batched.shape == (4, *singles[0].shape)
    np.testing.assert_array_equal(batched[0], batched[3])
    for i, s in enumerate(singles):
        # batch shape changes the CPU kernels' reduction tiling; the random
        # neck amplifies that float32 reordering noise, as in the JAX test.
        # A cross-frame leak would be orders of magnitude larger.
        np.testing.assert_allclose(batched[i], s, rtol=5e-3, atol=5e-3)
