"""Batch extraction on the CPU: ``DPTModel.prepare_image_bgr_nhwc`` against
the JAX facade's (1e-5), the batched contracts of
tests/test_batched_inference.py:69-88 on the port's DA-V2, BEiT and SwinV2,
and ``python -m muggled_dpt_tpu_torch.run_batch`` (``-d cpu``, float32)
against the JAX ``run_batch.py`` on the same tiny original-format
checkpoints (the TINY configs of tests/test_torch_apps.py) and frames: every
``.npy`` normalized to 0..1 within tests/test_torch_apps.py's RAW_TOL of the
JAX app's. Then the app's own contracts, mirroring
tests/test_apps_headless.py:136-201: a folder over two gloo ranks with a
padded last batch, equal to one rank's outputs; ``--eval_gt`` (0.0000 /
0.5000 / ln 2); video with ``--max_frames``; ``--per-chip-batch``; the
``-ar`` mixed-size refusal; ``-dp 1 -tp 2`` (two gloo ranks, one model
group) against the JAX app's ``-dp 1 -tp 2`` and against one rank, and
``-dp x -tp`` beyond the cards refused before any rank loads;
``--unroll``; no ``-d`` without a card exits non-zero."""

import os
import os.path as osp
import runpy
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from test_torch_apps import BEIT_TINY, DA_TINY, RAW_TOL, SWIN_TINY, _save

from muggled_dpt_tpu.demo_helpers import misc as jax_misc
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt, make_dpt_from_state_dict, make_swinv2_dpt
from muggled_dpt_tpu_torch import run_batch
from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as random_beit
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2
from muggled_dpt_tpu_torch.demo_helpers.postprocess import normalize_01

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
PREP_TOL = 1e-5


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch")
    rng = np.random.default_rng(7)
    frames = d / "frames"
    frames.mkdir()
    for i in range(3):  # 3 frames over batch 2: a padded last batch
        cv2.imwrite(str(frames / f"in_{i}.png"), rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    vw = cv2.VideoWriter(str(d / "vid.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (160, 120))
    for t in range(6):
        vw.write(np.roll(img, 5 * t, axis=1))
    vw.release()
    return {
        "dir": d,
        "frames": str(frames),
        "vid": str(d / "vid.mp4"),
        "da": _save(random_original_depth_anything_state_dict(DA_TINY, seed=4), d / "depth_anything_v2_tiny.pt"),
        "beit": _save(random_beit(BEIT_TINY, seed=3), d / "dpt_beit_tiny_512.pt"),
        "swinv2": _save(random_swinv2(SWIN_TINY, seed=3), d / "dpt_swin2_tiny_256.pt"),
    }


def _ours(fixtures, out, *extra):
    return run_batch.main(["-m", fixtures["da"], "-i", fixtures["frames"], "-o", str(out), "-d", DEVICE, *extra])


# -- prepare_image_bgr_nhwc ---------------------------------------------------


@pytest.mark.parametrize("family", ["da", "beit", "swinv2"])
def test_prepare_image_bgr_nhwc_matches_jax(fixtures, family):
    """(1, h, w, 3) on the model's device in its dtype, the BCHW
    preprocessing as a channels-last view, and the JAX facade's NHWC
    preprocessing of the same frame within 1e-5."""
    _, ours = make_dpt_from_state_dict(fixtures[family], device=DEVICE)
    _, theirs = jax_make_dpt(fixtures[family])
    img = cv2.imread(osp.join(fixtures["frames"], "in_0.png"))
    for side, square in ((None, True), (100, False)):
        x = ours.prepare_image_bgr_nhwc(img, side, square)
        h, w = ours.compute_scaled_hw(img.shape[:2], side, square)
        assert x.shape == (1, h, w, 3) and x.dtype == ours.dtype and x.device == ours.device
        assert torch.equal(x, ours.prepare_image_bgr(img, side, square).permute(0, 2, 3, 1))
        ref = np.asarray(theirs.prepare_image_bgr_nhwc(img, side, square))
        err = float(np.abs(x.numpy() - ref).max())
        assert err <= PREP_TOL, f"{family} side={side}: {err:.3e}"


def _assert_batched_matches_single(m, max_side):
    """tests/test_batched_inference.py's contract on the port: a (B, H, W, 3)
    stack through inference_rgb_device equals B single-frame calls
    (duplicate rows bit-equal; against singles within 5e-3)."""
    rng = np.random.default_rng(1)
    frames = [np.ascontiguousarray(rng.integers(0, 256, (120, 160, 3), np.uint8)) for _ in range(2)]
    hw = m.compute_scaled_hw(frames[0].shape[:2], max_side, True)
    singles = [m.inference_rgb_device(torch.from_numpy(f), hw)[0].numpy() for f in frames]
    batched = m.inference_rgb_device(torch.from_numpy(np.stack(frames + [frames[0]])), hw).numpy()
    assert batched.shape == (3, *singles[0].shape)
    np.testing.assert_array_equal(batched[0], batched[2])
    for i, s in enumerate(singles):
        np.testing.assert_allclose(batched[i], s, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("family", ["da", "beit", "swinv2"])
def test_batched_inference_matches_single(family):
    if family == "da":
        m = make_depthanythingv2_dpt(64, 2, 4, (16, 24, 32, 40), (37, 37), 16, device=DEVICE)
        _assert_batched_matches_single(m, 140)
    elif family == "beit":  # the relpos bias stack broadcasts over the batch
        _assert_batched_matches_single(make_beit_dpt(64, 4, 8, (8, 16, 32, 64), (6, 6), 16, device=DEVICE), 96)
    else:  # windows carved per image; shifted-window masks stay image-local
        m = make_swinv2_dpt((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16,
                            device=DEVICE)
        _assert_batched_matches_single(m, 64)


# -- run_batch against the JAX app -------------------------------------------


def _run_jax_batch(argv, monkeypatch):
    """The JAX run_batch.py in-process (8 virtual CPU devices, -dp 1), its
    persistent compilation cache left off."""
    monkeypatch.setattr(jax_misc, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["run_batch.py", *argv])
    runpy.run_path(osp.join(REPO_ROOT, "run_batch.py"), run_name="__main__")


@pytest.mark.parametrize("family", ["da", "beit", "swinv2"])
def test_run_batch_matches_jax(fixtures, tmp_path, monkeypatch, capsys, family):
    monkeypatch.chdir(tmp_path)
    flags = ["-m", fixtures[family], "-i", fixtures["frames"], "--save", "u16,npy"]
    stats = run_batch.main([*flags, "-o", "ours", "-d", DEVICE, "--per-chip-batch", "2"])
    out = capsys.readouterr().out
    assert stats["frames"] == 3 and stats["batch"] == 2 and "Done: 3 frames" in out and "batch per step: 2" in out
    _run_jax_batch([*flags, "-o", "theirs", "-dp", "1", "-f32", "--per-chip-batch", "2"], monkeypatch)
    assert "Done: 3 frames" in capsys.readouterr().out
    for i in range(3):
        ours, theirs = (np.load(tmp_path / d / f"in_{i}.npy") for d in ("ours", "theirs"))
        assert ours.shape == theirs.shape and ours.dtype == np.float32
        err = float(np.abs(normalize_01(ours) - normalize_01(theirs)).max())
        assert err < RAW_TOL, f"{family} in_{i}: normalized depth differs from the JAX app's by {err:.3e}"
        u16 = [cv2.imread(str(tmp_path / d / f"in_{i}.png"), cv2.IMREAD_UNCHANGED) for d in ("ours", "theirs")]
        assert u16[0].dtype == np.uint16 and u16[0].max() == 65535
        assert int(np.abs(u16[0].astype(np.int64) - u16[1]).max()) <= 1


# -- the app's own contracts --------------------------------------------------


def test_run_batch_data_parallel_two_ranks(fixtures, tmp_path, capsys):
    """-dp 2: two gloo ranks, 3 frames in batches of 2 (the last padded),
    each rank decoding and writing its own frames; every output equal to
    the single rank's, u16/npy/color written, and --eval_gt summed over the
    ranks. A video over two ranks (rank 0 decodes and scatters) equals one
    rank's run of it."""
    one = _ours(fixtures, tmp_path / "one", "--save", "u16,npy,color")
    gt = tmp_path / "gt"
    gt.mkdir()
    for i in range(3):
        np.save(gt / f"in_{i}.npy", np.load(tmp_path / "one" / f"in_{i}.npy") * 2.0)
    two = _ours(fixtures, tmp_path / "two", "--save", "u16,npy,color", "-dp", "2", "--eval_gt", str(gt))
    assert two["frames"] == one["frames"] == 3 and two["batch"] == 2 and one["batch"] == 1
    assert two["eval"]["abs_rel"] < 5e-5 and two["eval"]["delta1"] == 1.0
    saved = sorted(os.listdir(tmp_path / "two"))
    assert saved == sorted(f"in_{i}{s}" for i in range(3) for s in (".png", ".npy", "_color.png"))
    for i in range(3):
        a, b = (np.load(tmp_path / d / f"in_{i}.npy") for d in ("one", "two"))
        np.testing.assert_array_equal(a, b)
    a, b = (np.load(tmp_path / "two" / f"in_{i}.npy") for i in (0, 1))
    assert a.shape == b.shape and not np.allclose(a, b)  # frames differ: no padded-output mixups

    video = ["-m", fixtures["da"], "-i", fixtures["vid"], "-d", DEVICE, "--max_frames", "3", "--save", "npy"]
    one = run_batch.main([*video, "-o", str(tmp_path / "vid1")])
    two = run_batch.main([*video, "-o", str(tmp_path / "vid2"), "-dp", "2"])
    assert one["frames"] == two["frames"] == 3 and two["batch"] == 2
    names = [f"frame_{i:06d}.npy" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "vid1")) == sorted(os.listdir(tmp_path / "vid2")) == names
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "vid1" / n), np.load(tmp_path / "vid2" / n))


def test_run_batch_tensor_parallel_matches_jax(fixtures, tmp_path, monkeypatch, capsys):
    """-dp 1 -tp 2: two gloo ranks split one BEiT model (its 4 heads, 2
    each, and each rank's bias stack), 3 frames in batches of 2, the group's
    first rank decoding each step and writing every output; each .npy within
    RAW_TOL of the JAX app's ``-dp 1 -tp 2`` on the same folder and within
    1e-5 of one rank's run, and --eval_gt counted once per frame, not once
    per rank."""
    monkeypatch.chdir(tmp_path)
    flags = ["-m", fixtures["beit"], "-i", fixtures["frames"], "--save", "u16,npy", "--per-chip-batch", "2"]
    one = run_batch.main([*flags, "-o", "one", "-d", DEVICE])
    gt = tmp_path / "gt"
    gt.mkdir()
    for i in range(3):
        np.save(gt / f"in_{i}.npy", np.load(tmp_path / "one" / f"in_{i}.npy") * 2.0)
    two = run_batch.main([*flags, "-o", "ours", "-d", DEVICE, "-dp", "1", "-tp", "2", "--eval_gt", str(gt)])
    assert two["frames"] == one["frames"] == 3 and two["batch"] == 2
    assert two["eval"]["abs_rel"] < 5e-5 and two["eval"]["delta1"] == 1.0
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(f"in_{i}{e}" for i in range(3) for e in (".npy", ".png"))
    capsys.readouterr()
    _run_jax_batch([*flags, "-o", "theirs", "-dp", "1", "-tp", "2", "-f32"], monkeypatch)
    assert "'model': 2" in capsys.readouterr().out
    for i in range(3):
        ours, theirs, single = (np.load(tmp_path / d / f"in_{i}.npy") for d in ("ours", "theirs", "one"))
        err = float(np.abs(normalize_01(ours) - normalize_01(theirs)).max())
        assert err < RAW_TOL, f"in_{i}: normalized depth differs from the JAX app's -tp 2 by {err:.3e}"
        np.testing.assert_allclose(ours, single, rtol=1e-5, atol=1e-5)


def test_run_batch_eval_gt(fixtures, tmp_path, capsys):
    """--eval_gt: the model's own outputs x 2 as ground truth score perfect
    once SSI-aligned, and --eval_no_align exposes the 2x (rmse_log = ln 2)."""
    _ours(fixtures, tmp_path / "out", "--save", "npy")
    gt = tmp_path / "gt"
    gt.mkdir()
    for i in range(3):
        np.save(gt / f"in_{i}.npy", np.load(tmp_path / "out" / f"in_{i}.npy") * 2.0)
    capsys.readouterr()
    stats = _ours(fixtures, tmp_path / "out2", "--save", "npy", "--eval_gt", str(gt))
    line = next(l for l in capsys.readouterr().out.splitlines() if l.startswith("Eval vs"))
    assert "(3/3 frames, SSI-aligned)" in line and "abs_rel=0.0000" in line and "delta1=1.0000" in line
    assert stats["eval"]["abs_rel"] < 5e-5
    _ours(fixtures, tmp_path / "out3", "--save", "npy", "--eval_gt", str(gt), "--eval_no_align")
    line = next(l for l in capsys.readouterr().out.splitlines() if l.startswith("Eval vs"))
    assert "no-align" in line and "abs_rel=0.5000" in line and "rmse_log=0.6931" in line


def test_run_batch_video_max_frames(fixtures, tmp_path, capsys):
    stats = run_batch.main(["-m", fixtures["da"], "-i", fixtures["vid"], "-o", str(tmp_path / "vid"), "-d", DEVICE,
                            "--max_frames", "4", "--per-chip-batch", "3", "--save", "npy"])
    assert stats["frames"] == 4 and "Done: 4 frames" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "vid")) == [f"frame_{i:06d}.npy" for i in range(4)]


def test_run_batch_skips_unreadable_files(fixtures, tmp_path, capsys):
    """A file that does not decode is reported and has no output; the
    readable frames' outputs equal those of a folder without it."""
    folder = tmp_path / "frames"
    folder.mkdir()
    for i in range(3):
        (folder / f"in_{i}.png").write_bytes(open(osp.join(fixtures["frames"], f"in_{i}.png"), "rb").read())
    (folder / "in_1b.png").write_bytes(b"not a png")
    stats = run_batch.main(["-m", fixtures["da"], "-i", str(folder), "-o", str(tmp_path / "o"), "-d", DEVICE,
                            "--per-chip-batch", "2", "--save", "npy"])
    out = capsys.readouterr().out
    assert stats["frames"] == 3 and "Skipping" in out and "in_1b.png" in out and "Done: 3 frames" in out
    assert sorted(os.listdir(tmp_path / "o")) == [f"in_{i}.npy" for i in range(3)]
    ref = tmp_path / "ref"
    _ours(fixtures, ref, "--save", "npy", "--per-chip-batch", "2")
    for i in range(3):
        np.testing.assert_array_equal(np.load(tmp_path / "o" / f"in_{i}.npy"), np.load(ref / f"in_{i}.npy"))


def test_run_batch_refusals_and_notes(fixtures, tmp_path, capsys, monkeypatch):
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    rng = np.random.default_rng(2)
    cv2.imwrite(str(mixed / "a.png"), rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
    cv2.imwrite(str(mixed / "b.png"), rng.integers(0, 256, (160, 120, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="Mixed input sizes in aspect-ratio mode"):
        run_batch.main(["-m", fixtures["da"], "-i", str(mixed), "-o", str(tmp_path / "o"), "-d", DEVICE, "-ar"])
    # -dp x -tp beyond the visible cards: refused before any rank loads (here a card of one, faked)
    monkeypatch.setattr(run_batch, "make_device_config", lambda *a: {"device": torch.device("cuda", 0),
                                                                      "dtype": torch.bfloat16})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="-dp 1 x -tp 2 needs 2 CUDA cards, have 1"):
        run_batch.main(["-m", fixtures["da"], "-i", fixtures["frames"], "-o", str(tmp_path / "tp"), "-tp", "2"])
    assert not (tmp_path / "tp").exists()
    monkeypatch.undo()
    stats = _ours(fixtures, tmp_path / "unroll", "--unroll", "2", "--max_frames", "1")
    assert run_batch.UNROLL_NOTE in capsys.readouterr().out and stats["frames"] == 1
    with pytest.raises(ValueError, match="Unknown --save kinds"):
        _ours(fixtures, tmp_path / "bad", "--save", "exr")


def test_run_batch_without_card_exits_nonzero(fixtures, tmp_path):
    """No -d: the card, and without one the run exits non-zero with
    resolve_device's message, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    r = subprocess.run([sys.executable, "-m", "muggled_dpt_tpu_torch.run_batch", "-m", fixtures["da"], "-i",
                        fixtures["frames"], "-o", str(tmp_path / "o")], cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert r.returncode != 0 and "no CUDA device" in r.stderr
