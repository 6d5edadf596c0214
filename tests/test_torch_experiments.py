"""The port's analysis experiments and example on the CPU (``-d cpu``), on
tiny original-format checkpoints, as tests/test_apps_headless.py:85-110
runs the JAX ones: the two visualizers' --headless batch modes with the JAX
stdout markers, their interactive mode refused with a non-zero exit,
depth_masking with plane removal, internal_features for every family, and
every entry point refusing to fall back to the CPU without a card. Then the
port's copies of the demo helpers against the JAX package's on the same
arrays: postprocess (scale_prediction within float32 round-off, the rest
exact), plane_fit (same rng: equal) and saving (equal files)."""

import os
import os.path as osp
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from muggled_dpt_tpu.demo_helpers import plane_fit as jax_plane_fit
from muggled_dpt_tpu.demo_helpers import postprocess as jax_postprocess
from muggled_dpt_tpu.demo_helpers import saving as jax_saving
from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as random_beit
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2
from muggled_dpt_tpu_torch.demo_helpers import plane_fit, postprocess, saving
from muggled_dpt_tpu_torch.experiments import attention_visualization, block_norm_visualization, depth_masking, fusion_scaling
from muggled_dpt_tpu_torch.simple_examples import internal_features

REPO_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
DA_TINY = {"features_per_token": 64, "num_blocks": 4, "reassembly_features_list": [8, 16, 32, 64], "fusion_channels": 16,
           "patch_size_px": 14, "base_patch_grid_hw": (8, 8)}  # tests/test_apps_headless.py:18-25
BEIT_TINY = {"features_per_token": 64, "num_blocks": 4, "num_heads": 4, "reassembly_features_list": [8, 16, 32, 64],
             "fusion_channels": 16, "patch_size_px": 16, "base_patch_grid_hw": (6, 6)}
SWIN_TINY = {"features_per_stage": [16, 32, 64, 128], "heads_per_stage": [2, 4, 4, 8], "layers_per_stage": [2, 2, 2, 2],
             "base_patch_grid_hw": (16, 16), "window_size_hw": (4, 4), "pretrained_window_sizes_per_stage": [None] * 4,
             "fusion_channels": 16, "patch_size_px": 4}
VISUALIZERS = {  # module -> (stdout marker, files written for a 4-block model)
    "attention_visualization": ("row/column attention", [f"layer_{i:02d}.png" for i in range(4)]),
    "block_norm_visualization": ("per-block norm maps", ["all_blocks.png"] + [f"block_{i:02d}.png" for i in range(4)]),
}
MODULES = {"attention_visualization": attention_visualization, "block_norm_visualization": block_norm_visualization,
           "depth_masking": depth_masking, "fusion_scaling": fusion_scaling, "internal_features": internal_features}


def _save(sd, path) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("experiments")
    img = np.random.default_rng(0).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    img_path = str(d / "img.png")
    cv2.imwrite(img_path, img)
    return {
        "da": _save(random_original_depth_anything_state_dict(DA_TINY, seed=4), d / "depth_anything_v2_tiny.pt"),
        "beit": _save(random_beit(BEIT_TINY, seed=3), d / "dpt_beit_tiny_384.pt"),
        "swinv2": _save(random_swinv2(SWIN_TINY, seed=3), d / "dpt_swin2_tiny_256.pt"),
        "img": img_path,
        "image": img,
    }


@pytest.mark.parametrize("name", list(VISUALIZERS))
def test_visualizer_headless(fixtures, tmp_path, capsys, name):
    marker, files = VISUALIZERS[name]
    out = tmp_path / "out"
    MODULES[name].main(["-m", fixtures["da"], "-i", fixtures["img"], "--headless", "-d", "cpu", "-o", str(out)])
    assert marker in capsys.readouterr().out
    assert sorted(os.listdir(out)) == sorted(files)
    assert all(cv2.imread(str(out / f)) is not None for f in files)


@pytest.mark.parametrize("name", list(VISUALIZERS))
def test_visualizer_without_headless_exits_nonzero(fixtures, name):
    """The interactive explorer needs demo_helpers/ui.py (ROADMAP A12)."""
    with pytest.raises(SystemExit) as exc:
        MODULES[name].main(["-m", fixtures["da"], "-d", "cpu"])
    assert exc.value.code not in (0, None) and "A12" in str(exc.value.code)


def test_visualizer_without_headless_exit_code(fixtures):
    r = subprocess.run([sys.executable, "-m", "muggled_dpt_tpu_torch.experiments.attention_visualization",
                        "-m", fixtures["da"], "-d", "cpu"], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "ROADMAP A12" in r.stderr, (r.returncode, r.stderr[-500:])


def test_depth_masking_remove_plane(fixtures, tmp_path, capsys):
    out = tmp_path / "out"
    depth_masking.main(["-m", fixtures["da"], "-i", fixtures["img"], "--remove_plane", "-d", "cpu", "-o", str(out)])
    assert "Mask keeps" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["mask.png", "masked.png", "masked_rgba.png"]
    mask = cv2.imread(str(out / "mask.png"), cv2.IMREAD_UNCHANGED)
    assert mask.shape == fixtures["image"].shape[:2] and set(np.unique(mask)) <= {0, 255}
    assert cv2.imread(str(out / "masked_rgba.png"), cv2.IMREAD_UNCHANGED).shape == (120, 160, 4)


@pytest.mark.parametrize("family", ["da", "beit", "swinv2"])
def test_internal_features(fixtures, capsys, family):
    internal_features.main(["-m", fixtures[family], "-d", "cpu"])
    out = capsys.readouterr().out
    assert "depth" in out.lower() and "Fused feature map" in out and "(NCHW)" in out
    assert ("Patch tokens" in out) == (family == "da")


@pytest.mark.parametrize("name", list(MODULES))
def test_entry_points_need_a_card_by_default(fixtures, monkeypatch, name):
    """Without -d they build on the CUDA card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["-m", fixtures["da"]] + (["--headless"] if name in VISUALIZERS else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MODULES[name].main(args)


@pytest.mark.parametrize("shape,out_wh", [((30, 40), (70, 50)), ((1, 30, 40), (23, 17))])
def test_scale_prediction_matches_jax(shape, out_wh):
    pred = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jax_postprocess.scale_prediction(pred, out_wh)
    got = postprocess.scale_prediction(torch.from_numpy(pred), out_wh)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(postprocess.scale_prediction(pred, out_wh), got)  # numpy in, same result


def test_postprocess_matches_jax():
    rng = np.random.default_rng(2)
    depth = rng.standard_normal((24, 32)).astype(np.float32)
    depth[0, :3] = (np.inf, -np.inf, np.nan)
    for fn in ("remove_infinities", "normalize_01"):
        np.testing.assert_array_equal(getattr(postprocess, fn)(depth), getattr(jax_postprocess, fn)(depth))
    norm = jax_postprocess.normalize_01(jax_postprocess.remove_infinities(depth))
    u8 = jax_postprocess.convert_to_uint8(norm)
    np.testing.assert_array_equal(postprocess.convert_to_uint8(norm), u8)
    for lo, hi in ((0.0, 1.0), (0.1, 0.8)):
        np.testing.assert_array_equal(postprocess.histogram_equalization(u8, lo, hi),
                                      jax_postprocess.histogram_equalization(u8, lo, hi))
    for edge in (np.full((3, 3), np.inf, np.float32), np.ones((3, 3), np.float32)):
        np.testing.assert_array_equal(postprocess.normalize_01(postprocess.remove_infinities(edge)),
                                      jax_postprocess.normalize_01(jax_postprocess.remove_infinities(edge)))


def test_plane_fit_matches_jax():
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 0.01 * xx - 0.02 * yy + 0.05 * np.random.default_rng(3).standard_normal((h, w)).astype(np.float32)
    xyz, mean = plane_fit.sample_depth_grid(depth, rng=np.random.default_rng(4))
    jxyz, jmean = jax_plane_fit.sample_depth_grid(depth, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(mean, jmean)
    normal = plane_fit.find_plane_normal(xyz, mean)
    np.testing.assert_array_equal(normal, jax_plane_fit.find_plane_normal(jxyz, jmean))
    np.testing.assert_array_equal(plane_fit.make_plane_image((h, w), normal, mean),
                                  jax_plane_fit.make_plane_image((h, w), normal, mean))
    got = plane_fit.estimate_plane_of_best_fit(depth, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(got, jax_plane_fit.estimate_plane_of_best_fit(depth, rng=np.random.default_rng(5)))
    assert float(np.abs(depth - got).mean()) < 0.1  # the tilt is taken out
    with pytest.raises(TypeError):
        plane_fit.find_plane_normal(np.zeros((4, 2)))


def test_saving_matches_jax(tmp_path):
    depth = np.random.default_rng(6).standard_normal((20, 30)).astype(np.float32)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for mod, folder in ((saving, ours), (jax_saving, theirs)):
        mod.save_numpy_array(depth, "d", str(folder))
        mod.save_uint16_png(depth, "d16", str(folder))
        assert mod.save_image(np.zeros((4, 5, 3), np.uint8), "img", str(folder)) == str(folder / "img.png")
    for name in ("d.npy", "d16.png", "img.png"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    assert cv2.imread(str(ours / "d16.png"), cv2.IMREAD_UNCHANGED).dtype == np.uint16
    name = saving.make_save_name("/a/b/photo.jpg")
    assert name.startswith("photo_") and len(name) == len("photo_") + len("20260101_000000")
    assert saving.make_save_name(None).startswith("depth_")
