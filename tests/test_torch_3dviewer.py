"""The port's 3D-viewer server (``muggled_dpt_tpu_torch/run_3dviewer.py``) on
the CPU, in-process on 127.0.0.1, against the JAX app's server on the same
tiny checkpoint (tests/test_3dviewer_server.py builds it the same way): the
decoded lossless 24-bit /frame depths agree within 1e-4 (normalized 0..1
depth, float32 on both sides), the static files are the JAX package's
byte for byte, mesh export gives equal bytes, 4 concurrent /frame requests
equal a serial one while the inference lock lets one run at a time, and
/upload, a bad index, the whitelist's 404 and the entry point's refusal to
run without a card."""

import json
import os.path as osp
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT  # noqa: F401  (the repo root on sys.path, for the JAX app)

import run_3dviewer as jax_viewer
from muggled_dpt_tpu.demo_helpers import mesh_export as jax_mesh_export
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu_torch import run_3dviewer
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.demo_helpers import mesh_export
from muggled_dpt_tpu_torch.make_dpt import make_dpt_from_state_dict

DEVICE = "cpu"
TINY = {"features_per_token": 64, "num_blocks": 4, "reassembly_features_list": [8, 16, 32, 64], "fusion_channels": 16,
        "patch_size_px": 14, "base_patch_grid_hw": (8, 8)}
DEPTH_TOL = 1e-4


class ConcurrencyProbe:
    """A model whose ``inference`` records how many calls ran at once."""

    def __init__(self, model):
        self._model, self._lock, self.running, self.most, self.calls = model, threading.Lock(), 0, 0, 0

    def inference(self, *args):
        with self._lock:
            self.running += 1
            self.calls += 1
            self.most = max(self.most, self.running)
        try:
            return self._model.inference(*args)
        finally:
            with self._lock:
                self.running -= 1


def _serve(module, model, source, **kw):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(model, source, max_side=112, is_metric=False, **kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _decode_frame(body, headers):
    n = int(headers["X-rgb-size"])
    rgb = cv2.imdecode(np.frombuffer(body[:n], np.uint8), cv2.IMREAD_COLOR)
    depth_img = cv2.imdecode(np.frombuffer(body[n:], np.uint8), cv2.IMREAD_UNCHANGED)
    b, g, r = (depth_img[..., i].astype(np.uint32) for i in range(3))
    return rgb, ((r << 16) | (g << 8) | b) / (2**24 - 1), depth_img[..., 3]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = tmp_path_factory.mktemp("viewer")
    sd = random_original_depth_anything_state_dict(TINY, seed=11)
    ckpt = str(d / "depth_anything_v2_tiny.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    img = np.random.default_rng(1).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    img_path = str(d / "input.png")
    cv2.imwrite(img_path, img)
    _, model = make_dpt_from_state_dict(ckpt, device=DEVICE)
    probe = ConcurrencyProbe(model)
    ours, ours_base = _serve(run_3dviewer, probe, run_3dviewer.InputSource(img_path))
    _, jax_model = jax_make_dpt(ckpt)
    theirs, theirs_base = _serve(jax_viewer, jax_model, jax_viewer.InputSource(img_path))
    yield {"ours": ours_base, "theirs": theirs_base, "probe": probe, "model": model, "image": img, "ckpt": ckpt,
           "img_path": img_path}
    for httpd in (ours, theirs):
        httpd.shutdown()
        httpd.server_close()


def test_frame_matches_jax_server(servers):
    (s1, h1, b1), (s2, h2, b2) = _get(servers["ours"] + "/frame/0"), _get(servers["theirs"] + "/frame/0")
    assert s1 == s2 == 200 and int(h1["X-rgb-size"]) + int(h1["X-depth-size"]) == len(b1)
    rgb1, d1, a1 = _decode_frame(b1, h1)
    rgb2, d2, a2 = _decode_frame(b2, h2)
    assert np.array_equal(rgb1, rgb2) and rgb1.shape == (96, 128, 3)
    assert d1.shape == d2.shape == (112, 112) and d1.min() == 0 and d1.max() == 1
    assert float(np.abs(d1 - d2).max()) < DEPTH_TOL
    assert a1.max() == 255 and a1.min() < 255 and np.abs(a1.astype(int) - a2.astype(int)).max() <= 1


def test_frame_depth_is_the_facade_depth(servers):
    from muggled_dpt_tpu_torch.demo_helpers.postprocess import normalize_01, remove_infinities

    _, headers, body = _get(servers["ours"] + "/frame/0")
    _, depth, _ = _decode_frame(body, headers)
    want = normalize_01(remove_infinities(servers["model"].inference(servers["image"], 112).numpy().squeeze()))
    assert float(np.abs(depth - want).max()) <= 0.5 / (2**24 - 1) + 1e-7


def test_concurrent_frames_equal_a_serial_one(servers):
    probe = servers["probe"]
    _, _, serial = _get(servers["ours"] + "/frame/0")
    bodies, errors, before = [None] * 4, [], probe.calls

    def fetch(i):
        try:
            bodies[i] = _get(servers["ours"] + "/frame/0")[2]
        except Exception as e:  # noqa: BLE001  (reported by the assert below)
            errors.append(e)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(b == serial for b in bodies)
    assert probe.calls - before == 4 and probe.most == 1  # the lock: one inference at a time


def test_source_info_bad_index_and_whitelist(servers):
    info = json.loads(_get(servers["ours"] + "/get-source-info")[2])
    assert info == json.loads(_get(servers["theirs"] + "/get-source-info")[2])
    assert info == {"type": "image", "frame_count": 1, "fps": 0.0, "is_metric": False}
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(servers["ours"] + "/frame/abc")
    assert e.value.code == 400
    for path in ("/secret.txt", "/../run_3dviewer.py", "/index.html.bak"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(servers["ours"] + path)
        assert e.value.code == 404, path


@pytest.mark.parametrize("path", ["/", "/index.html", "/viewer.js", "/info.html"])
def test_static_files_are_the_jax_packages(servers, path):
    status, headers, body = _get(servers["ours"] + path)
    name = run_3dviewer.STATIC_WHITELIST[path]
    assert status == 200 and osp.dirname(run_3dviewer.VIEWER_DIR).endswith(osp.join("muggled_dpt_tpu_torch", "demo_helpers"))
    with open(osp.join(jax_viewer.VIEWER_DIR, name), "rb") as f:
        assert body == f.read()
    assert headers["Content-Type"] == _get(servers["theirs"] + path)[1]["Content-Type"]


def test_export_obj_matches_jax(servers):
    for query in ("grid=8", "grid=8&dmin=0.2&dmax=0.8"):
        s1, _, obj = _get(servers["ours"] + "/export/obj?" + query)
        s2, _, jax_obj = _get(servers["theirs"] + "/export/obj?" + query)
        assert s1 == s2 == 200 and obj.startswith(b"# muggled_dpt_tpu depth mesh")
        v1 = np.array([[float(x) for x in ln.split()[1:]] for ln in obj.decode().splitlines() if ln.startswith("v ")])
        v2 = np.array([[float(x) for x in ln.split()[1:]] for ln in jax_obj.decode().splitlines() if ln.startswith("v ")])
        assert v1.shape == v2.shape == (81, 3) and np.abs(v1 - v2).max() < 1e-3
        faces = [ln for ln in obj.decode().splitlines() if ln.startswith("f ")]
        assert faces == [ln for ln in jax_obj.decode().splitlines() if ln.startswith("f ")]
    assert _get(servers["ours"] + "/export/glb?grid=8")[2][:4] == b"glTF"


@pytest.mark.parametrize("kwargs", [{}, {"grid": 8, "scale": 0.4, "offset": 0.1}, {"grid": 33, "dmin": 0.2, "dmax": 0.7}])
def test_mesh_export_bytes_equal_jax(kwargs):
    depth = np.random.default_rng(2).random((37, 53)).astype(np.float32)
    assert mesh_export.export_obj(depth, **kwargs) == jax_mesh_export.export_obj(depth, **kwargs)
    assert mesh_export.export_glb(depth, **kwargs) == jax_mesh_export.export_glb(depth, **kwargs)


def test_upload_swaps_source(servers, tmp_path):
    source = run_3dviewer.InputSource(servers["img_path"])
    httpd, base = _serve(run_3dviewer, servers["model"], source)
    try:
        new_img = np.full((64, 80, 3), 128, np.uint8)
        new_img[:32] = 30
        req = urllib.request.Request(base + "/upload", data=cv2.imencode(".png", new_img)[1].tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
        _, headers, body = _get(base + "/frame/0")
        rgb, depth, _ = _decode_frame(body, headers)
        assert rgb.shape == (64, 80, 3) and depth.shape == (112, 112)
        req = urllib.request.Request(base + "/upload", data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=120)
        assert e.value.code == 400
        assert source.info()["type"] == "image" and source.path == "<uploaded>"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_entry_point_refuses_the_cpu_without_a_card(servers, monkeypatch):
    """No -d and no card: exits before it binds a port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bound = []
    monkeypatch.setattr(run_3dviewer, "ThreadingHTTPServer", lambda *a, **k: bound.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_3dviewer.main(["-m", servers["ckpt"], "-i", servers["img_path"], "-p", "0"])
    assert bound == []
