"""The port's demo helpers, conversion cache and loader contracts on the CPU
(``device="cpu"``), against the JAX package where both have the function:
history_keeper, the video reader (tests/test_video_helpers.py), the backend
watchdog (tests/test_helpers_and_cache.py:135), the device and dtype policy
of the apps, ``AsyncResult`` on CPU tensors, the converted-checkpoint cache
(tests/test_helpers_and_cache.py:72, plus invalidation and the JAX cache
beside it) and the loader edge cases of tests/test_loader_edge_cases.py:85,
:108, :126 and :11. Models: the tiny DA-V2 of tests/test_apps_headless.py:16.
Tolerances: a cached model equals a converted one exactly (the same float32
values); f16 and bf16 checkpoints serve within 2e-2 mean abs-rel of the f32
checkpoint (half-precision weights)."""

import json
import os
import os.path as osp
import time

import cv2
import numpy as np
import pytest
import torch

from muggled_dpt_tpu.checkpoints import cache as jax_cache
from muggled_dpt_tpu.demo_helpers.history_keeper import HistoryKeeper as JaxHistoryKeeper
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu_torch.checkpoints import cache
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.demo_helpers import misc
from muggled_dpt_tpu_torch.demo_helpers.history_keeper import HistoryKeeper
from muggled_dpt_tpu_torch.demo_helpers.video import LoopingVideoReader, create_video_capture
from muggled_dpt_tpu_torch import make_dpt
from muggled_dpt_tpu_torch.make_dpt import load_state_dict, make_dpt_from_state_dict

DEVICE = "cpu"
TINY = {"features_per_token": 64, "num_blocks": 4, "reassembly_features_list": [8, 16, 32, 64], "fusion_channels": 16,
        "patch_size_px": 14, "base_patch_grid_hw": (8, 8)}
HALF_ABS_REL = 2e-2


def _save(sd, path, dtype=None) -> str:
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    if dtype is not None:
        tensors = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}
    torch.save(tensors, str(path))
    return str(path)


def _abs_rel(a, b) -> float:
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(0).integers(0, 256, (120, 160, 3), dtype=np.uint8)


# ---------------------------------------------------------------------------
# history keeper, video reader


def test_history_keeper_roundtrip_matches_jax(tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for cls, folder in ((HistoryKeeper, ours), (JaxHistoryKeeper, theirs)):
        folder.mkdir()
        cls(str(folder)).store(model_path=str(tmp_path / "nonexistent.pt"), value=42, crop_xy1xy2_norm=[[0, 0], [1, 1]])
    assert (ours / ".history").read_bytes() == (theirs / ".history").read_bytes()
    hk = HistoryKeeper(str(ours))
    assert hk.read("value") == (True, 42)
    assert hk.read("model_path") == (False, None)  # *_path keys must exist on disk
    assert hk.read("crop_xy1xy2_norm") == (True, [[0, 0], [1, 1]])


@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (64, 48))
    assert vw.isOpened()
    for i in range(5):
        vw.write(np.full((48, 64, 3), i * 10, np.uint8))
    vw.release()
    return path


def test_capture_opts_into_rotation_metadata(tiny_video):
    cap = create_video_capture(tiny_video)
    try:
        assert cap.get(cv2.CAP_PROP_ORIENTATION_AUTO) == 1.0
    finally:
        cap.release()


def test_looping_reader_matches_jax(tiny_video):
    from muggled_dpt_tpu.demo_helpers.video import LoopingVideoReader as JaxReader

    ours, theirs = LoopingVideoReader(tiny_video), JaxReader(tiny_video)
    try:
        assert ours._cap.get(cv2.CAP_PROP_ORIENTATION_AUTO) == 1.0
        assert (ours.total_frames, ours.fps, ours.is_webcam) == (theirs.total_frames, theirs.fps, theirs.is_webcam)
        for _ in range(7):  # past the end: the reader loops
            (p1, i1, f1), (p2, i2, f2) = next(ours), next(theirs)
            assert (p1, i1) == (p2, i2) and f1.shape == (48, 64, 3) and np.array_equal(f1, f2)
        ours.seek(2)
        theirs.seek(2)
        assert next(ours)[1] == next(theirs)[1] == 2
    finally:
        ours.release()
        theirs.release()


def test_missing_video_raises():
    with pytest.raises(FileNotFoundError):
        create_video_capture(osp.join("definitely", "missing.mp4"))


# ---------------------------------------------------------------------------
# device policy, watchdog, read-back, the dispatch-ahead gate


def test_backend_watchdog_passive_and_transparent(capsys):
    assert misc.run_with_backend_watchdog(lambda: 41 + 1, timeout_s=5.0) == 42
    assert "unreachable" not in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="boom"):
        misc.run_with_backend_watchdog(lambda: (_ for _ in ()).throw(RuntimeError("boom")).close(), timeout_s=5.0)
    assert "unreachable" not in capsys.readouterr().out

    def _slow():
        time.sleep(0.25)
        return "done"

    assert misc.run_with_backend_watchdog(_slow, timeout_s=0.05) == "done"
    assert "unreachable" in capsys.readouterr().out


def test_device_config_policy(monkeypatch):
    assert misc.make_device_config("cpu") == {"device": torch.device("cpu"), "dtype": torch.float32}
    assert misc.make_device_config("cpu", prefer_bfloat16=False)["dtype"] == torch.float32  # as JAX: CPU is f32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no -d and no card: never the CPU
        misc.make_device_config(None)
    # on a card: bf16 by default, f32 with -f32, f16 with -u (the JAX package's policy)
    calls = []
    monkeypatch.setattr(misc, "resolve_device", lambda d: calls.append(d) or torch.device("cuda", 0))
    assert misc.make_device_config(None) == {"device": torch.device("cuda", 0), "dtype": torch.bfloat16}
    assert misc.make_device_config(None, use_float32=True)["dtype"] == torch.float32
    assert misc.make_device_config(None, prefer_bfloat16=False)["dtype"] == torch.float16
    assert calls == [None, None, None]


def test_depth_to_numpy_and_config_feedback(capsys):
    t = torch.tensor([[0.5, 1.25]], dtype=torch.bfloat16)
    got = misc.depth_to_numpy(t)
    assert got.dtype == np.float32 and np.array_equal(got, [[0.5, 1.25]])
    misc.print_config_feedback("/x/model.pt", misc.make_device_config("cpu"), use_cache=True)
    assert "Device: cpu | dtype: float32 | cache: True" in capsys.readouterr().out


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    return _save(random_original_depth_anything_state_dict(TINY, seed=8), d / "depth_anything_v2_tiny.pt")


def test_async_result_on_cpu_is_ready_and_equals_sync(tiny_ckpt, frame):
    _, model = make_dpt_from_state_dict(tiny_ckpt, device=DEVICE)
    gate = misc.AsyncResult(DEVICE)
    assert gate.is_ready() and gate.collect() is None
    for side, square in ((None, True), (84, False)):
        gate.dispatch(model, frame, side, square)
        assert gate.is_ready()
        got = gate.collect()
        want = misc.depth_to_numpy(model.inference(frame, side, square))
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert gate.collect() is None  # collected once


# ---------------------------------------------------------------------------
# conversion cache


def test_conversion_cache_roundtrip(tmp_path, frame, monkeypatch):
    path = _save(random_original_depth_anything_state_dict(TINY, seed=8), tmp_path / "depth_anything_v2_tiny.pt")
    cfg0, model0 = make_dpt_from_state_dict(path, device=DEVICE)
    calls = {"load": 0, "assemble": 0}  # a miss reads the checkpoint and builds once; a hit only builds
    for name, key in (("load_state_dict", "load"), ("assemble_model", "assemble")):
        real = getattr(make_dpt, name)
        monkeypatch.setattr(make_dpt, name, lambda *a, _real=real, _key=key, **k: calls.__setitem__(_key, calls[_key] + 1)
                            or _real(*a, **k))
    cfg1, model1 = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True)
    assert calls == {"load": 1, "assemble": 1}
    assert osp.exists(cache.cache_path_for(path)) and cache.cache_path_for(path).endswith(".dpt_torch_cache.npz")
    model_type, cfg_cached, sd = cache.load_converted(path)
    assert model_type == "depthanythingv2" and all(v.dtype == torch.float32 for v in sd.values())
    cfg2, model2 = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True, enable_optimizations=False)
    assert calls == {"load": 1, "assemble": 2}
    assert cfg2["enable_optimizations"] is False and cfg2["features_per_token"] == cfg0["features_per_token"]
    want = model0.inference(frame).numpy()
    for m in (model1, model2):
        assert np.array_equal(m.inference(frame).numpy(), want)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 56, 56)).astype(np.float32))
    assert torch.equal(model2.forward(x), model0.forward(x))
    _, bf16 = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and next(bf16.net.parameters()).dtype == torch.bfloat16


def test_conversion_cache_invalidated_when_checkpoint_changes(tmp_path, frame):
    path = _save(random_original_depth_anything_state_dict(TINY, seed=8), tmp_path / "depth_anything_v2_tiny.pt")
    _, first = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True)
    _save(random_original_depth_anything_state_dict(TINY, seed=9), path)  # same size: the mtime must move
    stamp = os.stat(path).st_mtime + 10
    os.utime(path, (stamp, stamp))
    assert cache.load_converted(path) is None
    _, second = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True)
    _, fresh = make_dpt_from_state_dict(path, device=DEVICE)
    assert np.array_equal(second.inference(frame).numpy(), fresh.inference(frame).numpy())
    assert not np.array_equal(second.inference(frame).numpy(), first.inference(frame).numpy())
    assert cache.load_converted(path) is not None  # rewritten for the new file


def test_jax_and_port_caches_side_by_side(tmp_path, frame):
    """Each package writes and reads only its own cache file."""
    path = _save(random_original_depth_anything_state_dict(TINY, seed=8), tmp_path / "depth_anything_v2_tiny.pt")
    _, jax_model = jax_make_dpt(path, conversion_cache=True)
    jax_file = jax_cache.cache_path_for(path)
    assert osp.exists(jax_file) and not osp.exists(cache.cache_path_for(path))
    assert cache.load_converted(path) is None  # the port never reads the JAX file
    _, ours = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True)
    port_file = cache.cache_path_for(path)
    assert osp.exists(port_file) and port_file != jax_file
    jax_bytes = open(jax_file, "rb").read()
    _, jax_again = jax_make_dpt(path, conversion_cache=True)  # reads its own file, which the port left alone
    assert open(jax_file, "rb").read() == jax_bytes
    depth = ours.inference(frame).numpy()
    assert _abs_rel(depth, np.asarray(jax_again.inference(frame))) < 1e-4
    # a file of the JAX kind under the port's name has a matching fingerprint but no format tag: refused
    os.replace(jax_file, port_file)
    assert cache.load_converted(path) is None
    _, rebuilt = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True)
    assert np.array_equal(rebuilt.inference(frame).numpy(), depth)
    with np.load(port_file) as data:
        assert json.loads(bytes(data["__meta__"]).decode())["format"] == cache.FORMAT


def test_conversion_cache_ignores_a_corrupt_file(tmp_path, frame):
    path = _save(random_original_depth_anything_state_dict(TINY, seed=8), tmp_path / "depth_anything_v2_tiny.pt")
    with open(cache.cache_path_for(path), "wb") as f:
        f.write(b"\x00" * 64)
    _, model = make_dpt_from_state_dict(path, device=DEVICE, conversion_cache=True)
    assert cache.load_converted(path) is not None
    _, fresh = make_dpt_from_state_dict(path, device=DEVICE)
    assert np.array_equal(model.inference(frame).numpy(), fresh.inference(frame).numpy())


# ---------------------------------------------------------------------------
# loader contracts (tests/test_loader_edge_cases.py)


def test_truncated_or_garbage_checkpoint_raises(tmp_path):
    good = tmp_path / "ok.pt"
    torch.save({"pretrained.cls_token": torch.zeros(1, 1, 8)}, str(good))
    raw = good.read_bytes()
    truncated, garbage = tmp_path / "depth_anything_v2_truncated.pt", tmp_path / "depth_anything_v2_garbage.pt"
    truncated.write_bytes(raw[: len(raw) // 2])
    garbage.write_bytes(b"\x00" * 256)
    for bad in (truncated, garbage):
        with pytest.raises(Exception):
            load_state_dict(str(bad))
        with pytest.raises(Exception):
            make_dpt_from_state_dict(str(bad), device=DEVICE)


def test_wrong_family_raises(tiny_ckpt):
    with pytest.raises(Exception):
        make_dpt_from_state_dict(tiny_ckpt, model_type="beit", device=DEVICE)


def test_unknown_model_type_message(tmp_path, capsys):
    ckpt = tmp_path / "mystery.pt"
    torch.save({"some.unrelated.key": torch.zeros(3)}, str(ckpt))
    with pytest.raises(NotImplementedError, match="Bad model type"):
        make_dpt_from_state_dict(str(ckpt), device=DEVICE)
    assert "Accepted model types" in capsys.readouterr().out


@pytest.mark.parametrize("half", [torch.float16, torch.bfloat16])
def test_half_precision_checkpoint_serves_f32(tmp_path, frame, half):
    sd = random_original_depth_anything_state_dict(TINY, seed=8)
    path = _save(sd, tmp_path / "depth_anything_v2_half.pt", dtype=half)
    loaded = load_state_dict(path)
    assert {v.dtype for v in loaded.values() if v.is_floating_point()} == {half}
    _, model = make_dpt_from_state_dict(path, device=DEVICE)
    assert model.dtype == torch.float32 and {p.dtype for p in model.net.parameters()} == {torch.float32}
    depth = model.inference(frame).numpy()
    assert depth.dtype == np.float32 and np.isfinite(depth).all()
    _, ref = make_dpt_from_state_dict(_save(sd, tmp_path / "depth_anything_v2_f32.pt"), device=DEVICE)
    assert _abs_rel(depth, ref.inference(frame).numpy()) < HALF_ABS_REL
