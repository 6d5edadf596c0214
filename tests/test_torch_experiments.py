"""The port's analysis experiments and example on the CPU (``-d cpu``), on
tiny original-format checkpoints, as tests/test_apps_headless.py:85-110
runs the JAX ones: the two visualizers' --headless batch modes with the JAX
stdout markers, their interactive explorers driven through a scripted
``DisplayWindow`` (clicks, slider moves, keys, then q) beside the JAX
explorers under the same script (equal frames at every step, equal saved
files; the JAX explorer renders the port's capture, which is held against
the JAX capture within ATTN_MAX_ABS / NORM_RTOL), the panels checked against
the maps captured once before the loop, which no event recomputes,
depth_masking with plane removal, internal_features for every family, and
every entry point refusing to fall back to the CPU without a card. Then the
port's copies of the demo helpers against the JAX package's on the same
arrays: postprocess (scale_prediction within float32 round-off, the rest
exact), plane_fit (same rng: equal) and saving (equal files)."""

import functools
import importlib.util
import os
import os.path as osp
import sys

import cv2
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from test_torch_ui import scripted_window

from muggled_dpt_tpu.demo_helpers import plane_fit as jax_plane_fit
from muggled_dpt_tpu.demo_helpers import postprocess as jax_postprocess
from muggled_dpt_tpu.demo_helpers import saving as jax_saving
from muggled_dpt_tpu.demo_helpers import ui as jax_ui
from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as random_beit
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2
from muggled_dpt_tpu_torch.demo_helpers import plane_fit, postprocess, saving, ui
from muggled_dpt_tpu_torch.make_dpt import make_dpt_from_state_dict
from muggled_dpt_tpu_torch.experiments import attention_visualization, block_norm_visualization, depth_masking, fusion_scaling
from muggled_dpt_tpu_torch.simple_examples import internal_features

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


JAX_SCRIPTS = {name: osp.join(REPO_ROOT, "experiments", f"{name}.py") for name in VISUALIZERS}
CAPTURES = {"attention_visualization": "capture_attention", "block_norm_visualization": "capture_block_norms"}
ATTN_MAX_ABS = 1e-3  # float16 attention maps: one float16 ulp below 2 (2^-10) plus float32 round-off
NORM_RTOL = 1e-4  # float32 token norms


@functools.lru_cache(maxsize=None)
def _jax_visualizer(name):
    """The JAX package's visualizer script as a module (its ``main`` reads ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", JAX_SCRIPTS[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _check_capture(name, theirs, ours):
    """The JAX script's own capture against the port's, on the same checkpoint and image."""
    if name == "attention_visualization":
        (attn, *grid, disp), (jattn, *jgrid, jdisp) = ours, theirs
        assert grid == jgrid and len(attn) == len(jattn)
        for i, (a, b) in enumerate(zip(attn, jattn)):
            assert a.dtype == b.dtype == np.float16 and a.shape == b.shape, i
            assert float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max()) <= ATTN_MAX_ABS, i
    else:
        (norms, disp), (jnorms, jdisp) = ours, theirs
        np.testing.assert_allclose(norms, jnorms, rtol=NORM_RTOL, atol=0)
    assert np.array_equal(disp, jdisp)


def _saved(folder) -> dict:
    return {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder))} if osp.exists(folder) else {}


@pytest.fixture
def scripted(monkeypatch, fixtures):
    """Run a visualizer's explorer under ``script`` twice: the port's (its
    ``main``) and the JAX script's (in-process, ``sys.argv`` patched), each
    through its own package's ``DisplayWindow`` class from ``scripted_window``
    with the same script. The JAX explorer is handed the maps the port
    captured, after its own capture is held against them (ATTN_MAX_ABS,
    NORM_RTOL), so the two explorers must render equal frames at every step
    and save the same files with equal bytes (the JAX one into
    ``<out_dir>_jax``). Returns (the port's last view, its window, the number
    of the port's capture forwards)."""
    ours_cls, theirs_cls = scripted_window(ui), scripted_window(jax_ui)
    monkeypatch.setattr(ui, "DisplayWindow", ours_cls)
    monkeypatch.setattr(jax_ui, "DisplayWindow", theirs_cls)

    def run(name, script, out_dir, width=400, family="da"):
        module, capture_name = MODULES[name], CAPTURES[name]
        load, capture = module.load_model, getattr(module, capture_name)
        forwards, captured = [], []

        def counted_load(args):
            model = load(args)
            forward = model.forward_with_internals
            model.forward_with_internals = lambda x: forwards.append(1) or forward(x)
            return model

        for cls in (ours_cls, theirs_cls):
            monkeypatch.setattr(cls, "script", script)
        monkeypatch.setattr(module, "load_model", counted_load)
        monkeypatch.setattr(module, capture_name, lambda *a: captured.append(capture(*a)) or captured[-1])
        view = module.main(["-m", fixtures[family], "-i", fixtures["img"], "-d", "cpu", "-o", str(out_dir),
                            "--display_size", str(width)])

        jax_module = _jax_visualizer(name)
        jax_capture = getattr(jax_module, capture_name)

        def handed_over(*a):
            _check_capture(name, jax_capture(*a), captured[0])
            return captured[0]

        jax_out = out_dir.parent / f"{out_dir.name}_jax"
        monkeypatch.setattr(jax_module, capture_name, handed_over)
        monkeypatch.setattr(sys, "argv", [JAX_SCRIPTS[name], "-m", fixtures[family], "-i", fixtures["img"],
                                          "-o", str(jax_out), "--display_size", str(width)])
        jax_module.main()

        ours, theirs = ours_cls.last, theirs_cls.last
        assert len(captured) == 1 and len(ours.frames) == len(theirs.frames)
        for i, (a, b) in enumerate(zip(ours.frames, theirs.frames)):
            assert a.shape == b.shape and np.array_equal(a, b), f"{name}: frame {i} differs from the JAX explorer's"
        assert _saved(out_dir) == _saved(jax_out), f"{name}: saved files differ from the JAX explorer's"
        return view, ours, len(forwards)

    return run


def _cmap(steps):
    bar = ui.ColormapsBar()
    for _ in range(steps):
        bar.next()
    return bar


def _captured_model(fixtures):
    return make_dpt_from_state_dict(fixtures["da"], device="cpu")[1]


def test_attention_explorer_clicks_slides_and_saves(scripted, fixtures, tmp_path):
    """Click the token (1, 2) on the input image, slide to layer 0 and the
    last head (the tiny ViT has one head of 64: head 0, not the mean), next
    colormap, hover the maps, save the view and all layers, quit."""
    width, gh = 400, 8  # 120x160 at max side 112 -> 112x112, an 8x8 grid

    def pick_token(w):
        top, height = w.row(0)
        w.click((1 + 0.5) / gh * width / 2, top + (2 + 0.5) / gh * height)  # left half: the input image

    def slide(row, x):
        def step(w):
            top, height = w.row(row)
            w.click(x, top + height // 2)
        return step

    def hover(w):
        top, height = w.row(0)
        w._on_mouse(cv2.EVENT_MOUSEMOVE, width * 3 // 4, top + height // 2, 0, None)
        return "c"

    out = tmp_path / "attn"
    view, window, captures = scripted("attention_visualization",
                                      [pick_token, slide(1, 0), slide(2, width - 1), hover, "s", "a"], out)
    assert captures == 1  # maps captured once before the loop; no event runs the model
    assert view["token"] == (1, 2) and view["layer"] == 0 and view["head"] == 0
    attn, g_h, g_w, cls, _ = attention_visualization.capture_attention(_captured_model(fixtures), fixtures["image"], None)
    want, _, _ = attention_visualization.render_view(attn, (1, 2), g_h, g_w, cls, 0, 0, _cmap(1))
    assert np.array_equal(view["panel"], want)
    assert len(window.frames) == 7 and all(f.shape[1] == width for f in window.frames)
    assert not np.array_equal(window.frames[0], window.frames[-1])
    saved = sorted(os.listdir(out))
    assert saved == sorted(["token_1_2_layer_00_head_0.png"] + [f"layer_{i:02d}.png" for i in range(4)])
    assert np.array_equal(cv2.imread(str(out / "token_1_2_layer_00_head_0.png")), view["panel"])


def test_attention_explorer_picks_a_head_of_four(scripted, fixtures, tmp_path):
    """The tiny BEiT (4 heads, a cls token, a 6x6 grid): slide to head 2,
    pick the token (4, 1), next colormap, save the view and all layers."""
    width, gh = 400, 6

    def head_2(w):
        top, height = w.row(2)
        w.click(10 + (width - 20) * 3 / 4, top + height // 2)  # heads -1..3 over the track

    def pick_token(w):
        top, height = w.row(0)
        w.click((4 + 0.5) / gh * width / 2, top + (1 + 0.5) / gh * height)
        return "c"

    out = tmp_path / "beit"
    view, window, captures = scripted("attention_visualization", [head_2, pick_token, "s", "a"], out, family="beit")
    assert captures == 1 and view["token"] == (4, 1) and view["head"] == 2 and view["layer"] == 3
    assert "token_4_1_layer_03_head_2.png" in os.listdir(out) and len(window.frames) == 5


def test_block_norm_explorer_slides_and_saves(scripted, fixtures, tmp_path):
    """Slide to block 1, hover the norm map, next colormap twice, save all blocks, then the view, quit."""
    width = 400

    def slide_to_block_1(w):
        top, height = w.row(1)
        w.click(10 + (width - 20) / 3, top + height // 2)  # blocks 0..3 over the track

    def hover(w):
        top, height = w.row(0)
        w._on_mouse(cv2.EVENT_MOUSEMOVE, width * 3 // 4, top + height // 2, 0, None)
        return "c"

    out = tmp_path / "norms"
    view, window, captures = scripted("block_norm_visualization", [slide_to_block_1, hover, "c", "a", "s"], out)
    assert captures == 1 and view["layer"] == 1
    norms, _ = block_norm_visualization.capture_block_norms(_captured_model(fixtures), fixtures["image"], None)
    assert np.array_equal(view["panel"], block_norm_visualization.render_view(norms, 1, _cmap(2)))
    assert len(window.frames) == 6
    saved = sorted(os.listdir(out))
    assert saved == sorted(["all_blocks.png"] + [f"block_{i:02d}.png" for i in range(4)])
    assert np.array_equal(cv2.imread(str(out / "block_01.png")), view["panel"])


@pytest.mark.parametrize("name", list(VISUALIZERS))
def test_explorer_opens_on_the_default_view(scripted, fixtures, tmp_path, name):
    """q at once: one frame, the default view (last block; the attention explorer: the centre token, head mean)."""
    view, window, captures = scripted(name, ["q"], tmp_path / "none")
    assert captures == 1 and len(window.frames) == 1 and not osp.exists(tmp_path / "none")
    module = MODULES[name]
    model, image = _captured_model(fixtures), fixtures["image"]
    if name == "attention_visualization":
        attn, gh, gw, cls, disp = module.capture_attention(model, image, None)
        want, _, _ = module.render_view(attn, (gw // 2, gh // 2), gh, gw, cls, len(attn) - 1, -1, _cmap(0))
        assert view["token"] == (gw // 2, gh // 2) and view["head"] == -1
    else:
        norms, disp = module.capture_block_norms(model, image, None)
        want = module.render_view(norms, norms.shape[0] - 1, _cmap(0))
    assert view["layer"] == 3 and np.array_equal(view["panel"], want)
    assert window.frames[0].shape[1] == 400 and disp.shape == (112, 112, 3)


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
