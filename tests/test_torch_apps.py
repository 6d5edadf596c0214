"""The port's apps on the CPU (``-d cpu``, float32) against the JAX apps on
the same tiny original-format checkpoints (the TINY configs of
tests/test_apps_headless.py:16-23 and :93-100) and the same image:
run_image --headless for DA-V2, BEiT and SwinV2 (the saved ``_raw.npy``
within 1e-5 max abs of the JAX app's, normalized 0..1 depth), run_video
--headless with ``-sync`` and dispatch-ahead under the flags of
tests/test_apps_headless.py:62-72 (every frame read, results shown, frames
recorded), and depth_prediction (within 1e-5 of the JAX example). Both
apps run in-process; each port app also runs once as ``python -m`` with no
``-d``, where it must exit non-zero with ``resolve_device``'s message: no
entry point falls back to the CPU."""

import glob
import os
import os.path as osp
import re
import runpy
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from test_torch_ui import scripted_window

from muggled_dpt_tpu.demo_helpers import misc as jax_misc
from muggled_dpt_tpu.demo_helpers import postprocess as jax_postprocess
from muggled_dpt_tpu.demo_helpers import ui as jax_ui
from muggled_dpt_tpu_torch import run_image, run_video
from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as random_beit
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2
from muggled_dpt_tpu_torch.demo_helpers import ui
from muggled_dpt_tpu_torch.simple_examples import depth_prediction

DA_TINY = {"features_per_token": 64, "num_blocks": 4, "reassembly_features_list": [8, 16, 32, 64], "fusion_channels": 16,
           "patch_size_px": 14, "base_patch_grid_hw": (8, 8)}
BEIT_TINY = {"features_per_token": 64, "num_blocks": 8, "num_heads": 4, "reassembly_features_list": [8, 16, 32, 64],
             "fusion_channels": 16, "patch_size_px": 16, "base_patch_grid_hw": (6, 6)}
SWIN_TINY = {"features_per_stage": [16, 32, 64, 128], "heads_per_stage": [2, 4, 4, 8], "layers_per_stage": [2, 2, 4, 2],
             "base_patch_grid_hw": (16, 16), "window_size_hw": (4, 4), "pretrained_window_sizes_per_stage": [None] * 4,
             "fusion_channels": 16, "patch_size_px": 4}
RAW_TOL = 1e-5
VIDEO_FLAGS = ["--headless", "--max_frames", "10", "-t", "5", "-nc", "-r", "--crop"]


def _save(sd, path) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    img = np.random.default_rng(0).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    cv2.imwrite(str(d / "img.png"), img)
    vw = cv2.VideoWriter(str(d / "vid.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (160, 120))
    for t in range(8):
        vw.write(np.roll(img, 5 * t, axis=1))
    vw.release()
    return {
        "da": _save(random_original_depth_anything_state_dict(DA_TINY, seed=4), d / "depth_anything_v2_tiny.pt"),
        "beit": _save(random_beit(BEIT_TINY, seed=3), d / "dpt_beit_tiny_512.pt"),
        "swinv2": _save(random_swinv2(SWIN_TINY, seed=3), d / "dpt_swin2_tiny_256.pt"),
        "img": str(d / "img.png"),
        "vid": str(d / "vid.mp4"),
    }


def _run_jax_app(script, argv, monkeypatch):
    """A JAX app's ``main`` in-process, ``sys.argv`` patched; its persistent
    compilation cache left off (it would outlive the test in this process)."""
    monkeypatch.setattr(jax_misc, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [script, *argv])
    return runpy.run_path(osp.join(REPO_ROOT, script), run_name="__main__")


@pytest.mark.parametrize("family", ["da", "beit", "swinv2"])
def test_run_image_headless_matches_jax(fixtures, tmp_path, monkeypatch, capsys, family):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    monkeypatch.chdir(ours)
    saved = run_image.main(["-m", fixtures[family], "-i", fixtures["img"], "--headless", "-d", "cpu"])
    assert "Saved:" in capsys.readouterr().out
    assert [osp.exists(p) for p in saved] == [True] * 3
    colored, raw = cv2.imread(saved[0]), np.load(saved[1])
    assert colored.shape == (120, 160, 3) and raw.shape == (120, 160) and raw.dtype == np.float32
    assert cv2.imread(saved[2], cv2.IMREAD_UNCHANGED).dtype == np.uint16

    monkeypatch.chdir(theirs)
    _run_jax_app("run_image.py", ["-m", fixtures[family], "-i", fixtures["img"], "--headless", "-d", "cpu", "-f32"],
                 monkeypatch)
    (jax_raw,) = glob.glob(str(theirs / "saved_results" / "*_raw.npy"))
    err = float(np.abs(raw - np.load(jax_raw)).max())
    assert err < RAW_TOL, f"{family}: _raw.npy differs from the JAX app's by {err:.3e}"


@pytest.mark.parametrize("mode", [["-sync"], []], ids=["sync", "dispatch_ahead"])
def test_run_video_headless(fixtures, tmp_path, monkeypatch, mode):
    monkeypatch.chdir(tmp_path)
    stats = run_video.main(["-m", fixtures["da"], "-i", fixtures["vid"], "-d", "cpu", *VIDEO_FLAGS, *mode])
    assert stats["frames"] == 10 and len(stats["host_ms"]) == 10  # the CPU result is ready at once
    assert stats["shown"] == 9 and stats["fps"] > 0
    assert len(stats["infer_ms"]) == (10 if mode else 0)
    frames = sorted(os.listdir(stats["record_folder"]))
    assert stats["recorded"] == 9 and frames == [f"frame_{i:06d}.png" for i in range(8)]  # the 8-frame clip loops
    assert cv2.imread(osp.join(stats["record_folder"], frames[0])).shape == (120, 160, 3)


LABEL = re.compile(r"^\d+\.\d ms( \(dispatch\))?$")  # run_video's timing label, drawn on every shown frame
U8_MAX_FLIPS = 0.01  # share of depth pixels whose uint8 level may differ from the JAX app's, by one level


def _skip_timing_labels(monkeypatch, ui_module, labels):
    """``ui_module.TextDrawer`` drawing every text but run_video's timing
    label, which it records instead: the label is a time, and no two runs share it."""

    class Drawer(ui_module.TextDrawer):
        def draw(self, image, text, xy, color=None, anchor="topleft"):
            if LABEL.match(text):
                labels.append(text)
                return image
            return super().draw(image, text, xy, color, anchor)

    monkeypatch.setattr(ui_module, "TextDrawer", Drawer)


@pytest.mark.parametrize("mode", [["-sync"], []], ids=["sync", "dispatch_ahead"])
def test_run_video_window_matches_jax(fixtures, tmp_path, monkeypatch, mode):
    """Both run_video apps with a window (a ``scripted_window`` of each
    package's ui pressing o, record, at the first frame) on the same flags,
    clip and checkpoint. Each depth's uint8 levels are within one level of
    the JAX app's on all but U8_MAX_FLIPS of the pixels; the JAX app then
    renders the port's levels, so the windows' frames must be equal at every
    step and the recorded frames equal in name and bytes, the timing label
    left out of both. On the CPU the port's gate is ready at once; in
    dispatch-ahead mode the JAX gate is made to wait for its result too, so
    both show the same frames' depths."""
    flags = ["-m", fixtures["da"], "-i", fixtures["vid"], "-d", "cpu", "-f32", "-s", "400", "--max_frames", "10",
             "-t", "5", "-nc", "-r", *mode]
    script = ["o"] + [None] * 20
    ours_cls, theirs_cls = scripted_window(ui), scripted_window(jax_ui)
    for module, cls in ((ui, ours_cls), (jax_ui, theirs_cls)):
        monkeypatch.setattr(module, "DisplayWindow", cls)
        monkeypatch.setattr(cls, "script", script)
    labels = {"ours": [], "theirs": []}
    _skip_timing_labels(monkeypatch, ui, labels["ours"])
    _skip_timing_labels(monkeypatch, jax_ui, labels["theirs"])
    ours_u8, theirs_u8 = [], []
    monkeypatch.setattr(run_video, "convert_to_uint8",
                        lambda d, _f=run_video.convert_to_uint8: ours_u8.append(_f(d)) or ours_u8[-1])
    monkeypatch.setattr(jax_postprocess, "convert_to_uint8",  # read by the JAX app's import when it runs
                        lambda d, _f=jax_postprocess.convert_to_uint8: theirs_u8.append(_f(d)) or ours_u8[len(theirs_u8) - 1])

    def ready_when_done(gate):
        if gate._pending is not None:
            gate._pending.block_until_ready()
        return True

    monkeypatch.setattr(jax_misc.AsyncResult, "is_ready", ready_when_done)
    for who in ("ours", "theirs"):
        (tmp_path / who).mkdir()
    monkeypatch.chdir(tmp_path / "ours")
    stats = run_video.main(flags)
    monkeypatch.chdir(tmp_path / "theirs")
    _run_jax_app("run_video.py", flags, monkeypatch)

    assert stats["frames"] == 10 and stats["shown"] == 9 and len(ours_u8) == len(theirs_u8) == 9
    for i, (a, b) in enumerate(zip(ours_u8, theirs_u8)):
        diff = np.abs(a.astype(np.int16) - b)
        assert a.shape == b.shape and diff.max() <= 1 and (diff > 0).mean() <= U8_MAX_FLIPS, (i, diff.max())
    ours, theirs = ours_cls.last, theirs_cls.last
    assert len(ours.frames) == len(theirs.frames) == 10
    for i, (a, b) in enumerate(zip(ours.frames, theirs.frames)):
        assert a.shape == b.shape and np.array_equal(a, b), f"window frame {i} differs from the JAX app's"
    assert len(labels["ours"]) == len(labels["theirs"]) == 9
    assert {label.endswith("(dispatch)") for label in labels["ours"] + labels["theirs"]} == {not mode}
    recorded = [glob.glob(str(tmp_path / who / "saved_results" / "*" / "frame_*.png")) for who in ("ours", "theirs")]
    names = [sorted(osp.basename(p) for p in paths) for paths in recorded]
    assert names[0] == names[1] == [f"frame_{i:06d}.png" for i in range(8)]  # the 8-frame clip loops
    for a, b in zip(*(sorted(paths, key=osp.basename) for paths in recorded)):
        assert open(a, "rb").read() == open(b, "rb").read(), osp.basename(a)


def test_depth_prediction_matches_jax(fixtures, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ours = depth_prediction.main(["-m", fixtures["da"], "-i", fixtures["img"], "--no_display", "-d", "cpu"])
    assert "Inverse depth shape: (1, 112, 112)" in capsys.readouterr().out
    theirs = _run_jax_app(osp.join("simple_examples", "depth_prediction.py"),
                          ["-m", fixtures["da"], "-i", fixtures["img"], "--no_display"], monkeypatch)["depth_norm"]
    assert ours.shape == theirs.shape == (112, 112)
    assert float(np.abs(ours - theirs).max()) < RAW_TOL


APPS = {
    "run_image": ["-i", "{img}", "--headless"],
    "run_video": ["-i", "{vid}", "--headless", "--max_frames", "2"],
    "run_3dviewer": ["-i", "{img}", "-p", "0"],
    "simple_examples.depth_prediction": ["-i", "{img}", "--no_display"],
}


@pytest.mark.parametrize("app", list(APPS))
def test_entry_point_without_a_card_exits_nonzero(fixtures, tmp_path, app):
    args = ["-m", fixtures["da"]] + [a.format(**fixtures) for a in APPS[app]]
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"muggled_dpt_tpu_torch.{app}", *args], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stdout[-1000:]
    assert "no CUDA device" in r.stderr and 'pass device="cpu"' in r.stderr, r.stderr[-1000:]
    assert "Serving" not in r.stdout and "Saved" not in r.stdout
