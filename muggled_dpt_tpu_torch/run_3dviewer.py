"""Browser-based 3D depth viewer, the counterpart of the JAX package's
``run_3dviewer.py``: serves a WebGL page that displaces a dense plane mesh by
the model's depth prediction, for images, videos or webcam, with OBJ/GLB
export done client-side.

    python -m muggled_dpt_tpu_torch.run_3dviewer -m CKPT -i IMAGE_OR_VIDEO [-p PORT] [-d cpu]

Runs on the CUDA card in bfloat16 unless ``-d cpu`` (float32) is given, and
exits with an error, before it binds a port, where there is no card. The
server answers each request on a thread of its own; one lock serializes the
model's inference (one model, one card: the per-grid aux cache and the
kernels' launch counters are not shared-state safe).

Protocol (mirrors the reference's wire format, run_3dviewer.py:563-707):
  GET  /                  -> viewer page (static whitelist for html/js)
  GET  /frame/<idx>       -> body = rgb_png + depth_png concatenated;
                             X-rgb-size / X-depth-size headers give lengths.
                             Depth is packed 24-bit into the R,G,B bytes of a
                             PNG (browsers have no >8-bit image channels,
                             reference run_3dviewer.py:586-590); alpha carries
                             an edge mask (Sobel magnitude of depth) used to
                             hide 'stretchy' mesh edges (reference MaskData,
                             run_3dviewer.py:395-500).
  GET  /get-source-info   -> JSON {type, frame_count, fps, is_metric}
  POST /upload            -> replace the current input with an uploaded image
"""

import argparse
import contextlib
import json
import os.path as osp
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import cv2
import numpy as np

from .demo_helpers.history_keeper import HistoryKeeper
from .demo_helpers.loading import ask_for_model_path, ask_for_path
from .demo_helpers.misc import DEVICE_HELP, depth_to_numpy, make_device_config, maybe_quantize_int8, reduce_overthreading
from .demo_helpers.postprocess import normalize_01, remove_infinities
from .demo_helpers.video import create_video_capture
from .make_dpt import make_dpt_from_state_dict

VIEWER_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "demo_helpers", "viewer3d")  # the port's own copy
STATIC_WHITELIST = {
    "/": "index.html",
    "/index.html": "index.html",
    "/viewer.js": "viewer.js",
    "/info.html": "info.html",  # standalone docs (reference 3dviewer/info.html)
}

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class InputSource:
    """Polymorphic image / video / webcam input (reference run_3dviewer.py:171-291)."""

    def __init__(self, path_or_cam: str):
        self._lock = threading.Lock()
        self._set_source(path_or_cam)

    def _set_source(self, path_or_cam: str):
        self.is_webcam = str(path_or_cam).isdigit()
        self.is_image = (not self.is_webcam) and str(path_or_cam).lower().endswith(IMAGE_EXTS)
        self.path = str(path_or_cam)
        if self.is_image:
            self._image = cv2.imread(self.path)
            assert self._image is not None, f"Could not read image: {self.path}"
            self._cap = None
            self.frame_count, self.fps = 1, 0.0
        else:
            src = int(self.path) if self.is_webcam else self.path
            self._cap = create_video_capture(src)
            self._image = None
            self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)) if not self.is_webcam else -1
            self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0

    def swap_to_image_bytes(self, data: bytes) -> bool:
        """POST /upload support: replace the source with an uploaded image."""
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            return False
        with self._lock:
            if self._cap is not None:
                self._cap.release()
            self._cap, self._image = None, arr
            self.is_image, self.is_webcam = True, False
            self.frame_count, self.fps = 1, 0.0
            self.path = "<uploaded>"
        return True

    def read_frame(self, idx: int) -> np.ndarray | None:
        with self._lock:
            if self._image is not None:
                return self._image
            if self.is_webcam:
                ok, frame = self._cap.read()
                return frame if ok else None
            if self.frame_count > 0:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx % self.frame_count)
            ok, frame = self._cap.read()
            return frame if ok else None

    def info(self) -> dict:
        kind = "webcam" if self.is_webcam else ("image" if self.is_image else "video")
        return {"type": kind, "frame_count": self.frame_count, "fps": self.fps}


class CropState:
    """Persistent normalized crop applied to every frame (reference CropData,
    run_3dviewer.py:296-319; video-path cropping :361-377). Slices are derived
    from each frame's own shape, so the crop survives source swaps/uploads."""

    def __init__(self, xy1xy2_norm):
        self.xy1xy2_norm = xy1xy2_norm

    def is_cropping(self) -> bool:
        (x1, y1), (x2, y2) = self.xy1xy2_norm
        return (x2 - x1) < 0.999 or (y2 - y1) < 0.999

    def apply(self, frame: np.ndarray) -> np.ndarray:
        h, w = frame.shape[:2]
        (x1n, y1n), (x2n, y2n) = self.xy1xy2_norm
        y0 = int(round(y1n * h))
        x0 = int(round(x1n * w))
        y1 = max(int(round(y2n * h)), y0 + 1)
        x1 = max(int(round(x2n * w)), x0 + 1)
        return frame[y0:y1, x0:x1]


class MaskSource:
    """Loaded-mask-or-edge-fallback alpha provider (reference MaskData,
    run_3dviewer.py:395-500). A mask file is read once as grayscale and
    resized per depth shape; without one, the alpha is the reference's
    blurred-Sobel edge magnitude, normalized and inverted (low alpha = steep
    depth edge -> the client hides those 'stretchy' triangles)."""

    def __init__(self, mask_path: str | None):
        self.image = None
        if mask_path is not None:
            img = cv2.imread(mask_path)
            assert img is not None, f"Unable to read mask image: {mask_path}"
            self.image = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)

    @property
    def has_loaded_mask(self) -> bool:
        return self.image is not None

    def get_mask_uint8(self, depth_01: np.ndarray) -> np.ndarray:
        if self.image is not None:
            return cv2.resize(self.image, (depth_01.shape[1], depth_01.shape[0]))
        # edge fallback: gaussian blur then 3/10/3 Sobel-style derivative on
        # the float prediction, combined magnitude inverted to uint8
        # (reference compute_edges_uint8 + filter builders, :457-500)
        blurred = cv2.GaussianBlur(depth_01.astype(np.float32), (5, 5), 0, borderType=cv2.BORDER_REFLECT)
        kdy = np.array([[3, 10, 3], [0, 0, 0], [-3, -10, -3]], np.float32)
        dy = cv2.filter2D(blurred, cv2.CV_32F, kdy, borderType=cv2.BORDER_REFLECT)
        dx = cv2.filter2D(blurred, cv2.CV_32F, kdy.T, borderType=cv2.BORDER_REFLECT)
        mag = np.sqrt(dx * dx + dy * dy)
        return 255 - np.round(255.0 * mag / max(float(mag.max()), 1e-9)).astype(np.uint8)


# treat every encoding except these as lossy for the depth packing: webp &
# co. default to lossy in cv2, and lossy G/B bytes decode as huge depth jumps
LOSSLESS_EXTS = {".png", ".bmp"}


def _is_lossy(ext: str) -> bool:
    return ext not in LOSSLESS_EXTS


def predict_depth(model, frame, max_side, use_square, lock=None) -> np.ndarray:
    """The model's (H, W) float32 depth of a BGR frame, on the host; under
    ``lock`` where one is given (the server's threads share one model)."""
    with lock or contextlib.nullcontext():
        return depth_to_numpy(model.inference(frame, max_side, use_square)).squeeze()


def encode_frame(model, source, idx, max_side, is_metric, mask=None, crop=None, jpg_quality=80,
                 use_square=True, rgb_ext=".jpg", depth_ext=".png", lock=None):
    """Run inference (under ``lock``, if given) and encode (rgb_bytes,
    depth_bytes) in the given formats."""
    frame = source.read_frame(idx)
    if frame is None:
        return None, None
    if crop is not None:
        frame = crop.apply(frame)
    depth = predict_depth(model, frame, max_side, use_square, lock)
    if not is_metric:
        depth = normalize_01(remove_infinities(depth))

    # 24-bit packing into R,G,B (reference run_3dviewer.py:579-590); lossy
    # depth encodings keep only the top 8 bits to limit distortion (:585)
    d24 = np.clip(np.round(depth * (2**24 - 1)), 0, 2**24 - 1).astype(np.uint32)
    packed = np.zeros((*depth.shape, 3), np.uint8)
    packed[..., 2] = (d24 >> 16) & 255  # R (cv2 is BGR)
    if not _is_lossy(depth_ext):
        packed[..., 1] = (d24 >> 8) & 255
        packed[..., 0] = d24 & 255

    depth_01 = depth if not is_metric else cv2.normalize(depth, None, 0.0, 1.0, cv2.NORM_MINMAX)
    alpha = (mask or MaskSource(None)).get_mask_uint8(depth_01)  # direct callers may pass None
    # JPEG has no alpha channel — lossy depth ships without the edge mask
    depth_img = packed if _is_lossy(depth_ext) else np.dstack([packed, alpha])

    rgb_params = [cv2.IMWRITE_JPEG_QUALITY, jpg_quality] if rgb_ext in (".jpg", ".jpeg") else []
    ok1, rgb_bytes = cv2.imencode(rgb_ext, frame, rgb_params)
    ok2, depth_bytes = cv2.imencode(depth_ext, depth_img)
    if not (ok1 and ok2):
        return None, None
    return rgb_bytes.tobytes(), depth_bytes.tobytes()


def make_handler(model, source, max_side, is_metric, mask=None, crop=None,
                 use_square=True, rgb_ext=".jpg", depth_ext=".png"):
    mask = mask or MaskSource(None)  # build the edge-fallback provider once
    infer_lock = threading.Lock()  # one model, one card: requests run their inference one at a time

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, body=b"", content_type="text/plain", extra_headers=None):
            try:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # tolerate client disconnects (reference run_3dviewer.py:606-611)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in STATIC_WHITELIST:
                file_path = osp.join(VIEWER_DIR, STATIC_WHITELIST[path])
                ctype = "text/html" if file_path.endswith(".html") else "application/javascript"
                with open(file_path, "rb") as f:
                    return self._send(200, f.read(), ctype)
            if path == "/get-source-info":
                info = dict(source.info(), is_metric=is_metric)
                return self._send(200, json.dumps(info).encode(), "application/json")
            if path.startswith("/frame/"):
                try:
                    idx = int(path.split("/")[-1])
                except ValueError:
                    return self._send(400, b"bad frame index")
                rgb, depth = encode_frame(model, source, idx, max_side, is_metric, mask=mask, crop=crop,
                                          use_square=use_square, rgb_ext=rgb_ext, depth_ext=depth_ext, lock=infer_lock)
                if rgb is None:
                    return self._send(503, b"no frame")
                return self._send(
                    200,
                    rgb + depth,
                    "application/octet-stream",
                    {"X-rgb-size": str(len(rgb)), "X-depth-size": str(len(depth))},
                )
            if path in ("/export/obj", "/export/glb"):
                # headless mesh export (same math as the browser client's
                # exportOBJ/exportGLB; demo_helpers/mesh_export.py)
                from urllib.parse import parse_qs

                from .demo_helpers.mesh_export import export_glb, export_obj

                q = parse_qs(self.path.split("?")[1]) if "?" in self.path else {}

                def qf(name, default, cast=float):
                    # non-finite floats ('nan'/'inf' parse fine) would poison
                    # every exported vertex via the depth remap — reject them
                    try:
                        val = cast(q[name][0])
                        return val if np.isfinite(val) else default
                    except (KeyError, ValueError, IndexError):
                        return default

                frame = source.read_frame(qf("frame", 0, int))
                if frame is None:
                    return self._send(503, b"no frame")
                if crop is not None:
                    frame = crop.apply(frame)
                d = normalize_01(remove_infinities(predict_depth(model, frame, max_side, use_square, infer_lock)))
                kwargs = dict(grid=min(max(qf("grid", 320, int), 2), 1024), scale=qf("scale", 0.6), offset=qf("offset", 0.0),
                              dmin=qf("dmin", 0.0), dmax=qf("dmax", 1.0))
                if path.endswith("obj"):
                    return self._send(200, export_obj(d, **kwargs), "text/plain")
                return self._send(200, export_glb(d, **kwargs), "model/gltf-binary")
            return self._send(404, b"not found")

        def do_POST(self):
            if self.path.split("?")[0] == "/upload":
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
                ok = source.swap_to_image_bytes(data)
                return self._send(200 if ok else 400, b"ok" if ok else b"bad image")
            return self._send(404, b"not found")

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve the browser 3D depth viewer")
    parser.add_argument("-i", "--input_path", default=None, help="Image/video path or webcam number")
    parser.add_argument("-m", "--model_path", default=None)
    parser.add_argument("-cam", "--use_webcam", action="store_true", help="Use webcam 0 as the input")
    parser.add_argument("-b", "--base_size_px", default=None, type=int)
    parser.add_argument("-p", "--port", default=8000, type=int)
    parser.add_argument("-t", "--host", default="localhost", help="Server host")
    parser.add_argument("-d", "--device", default=None, help=DEVICE_HELP)
    parser.add_argument("-f32", "--use_float32", action="store_true")
    parser.add_argument("--int8", action="store_true", help="int8 encoder serving tier (see docs/performance.md)")
    parser.add_argument("--int8-full", dest="int8_full", action="store_true",
                        help="int8 tier incl. the full neck: reassembly GEMMs + fusion/head convs (implies --int8; docs/performance.md)")
    parser.add_argument("-nc", "--no_cache", action="store_true",
                        help="Disable per-grid aux caching to reduce device memory use")
    parser.add_argument("-z", "--no_optimization", action="store_true", help="Disable attention optimizations")
    parser.add_argument("-ar", "--use_aspect_ratio", action="store_true", help="Process at the input's aspect ratio")
    parser.add_argument("-l", "--launch", action="store_true", help="Automatically open the viewer page in a browser")
    parser.add_argument("--encode_image", default="jpg", help="Encoding for the RGB image data (default: jpg)")
    parser.add_argument(
        "--encode_depth", default="png",
        help="Encoding for the depth data (default: png; lossy formats keep only the top 8 depth bits, "
             "reference run_3dviewer.py:585-590)",
    )
    parser.add_argument(
        "-k", "--mask_path", default=None,
        help="Path to a binary mask image used as the depth alpha channel "
             "(eliminates sections outside masked areas; reference run_3dviewer.py:50-55)",
    )
    parser.add_argument("--crop", action="store_true", help="Interactively crop the input before inference (persisted)")
    args = parser.parse_args(argv)

    reduce_overthreading()
    device_config = make_device_config(args.device, args.use_float32)
    history = HistoryKeeper()
    _, hist_input = history.read("input_path")
    _, hist_model = history.read("model_path")
    if args.use_webcam:
        input_path = "0"
    else:
        input_path = args.input_path or ask_for_path("Enter path to image/video (or webcam number)", hist_input, must_exist=False)
    model_path = args.model_path or ask_for_model_path(default_path=hist_model)
    history.store(input_path=str(input_path), model_path=model_path)

    print("", "Loading model weights...", f"  @ {model_path}", sep="\n", flush=True)
    config, model = make_dpt_from_state_dict(
        model_path, enable_cache=not args.no_cache, enable_optimizations=not args.no_optimization,
        dtype=device_config["dtype"], device=device_config["device"],
    )
    model = maybe_quantize_int8(model, args.int8, args.int8_full)
    is_metric = bool(config.get("is_metric", False))
    max_side = args.base_size_px or model.default_size_px
    use_square = not args.use_aspect_ratio

    def norm_ext(e: str) -> str:
        e = e.lower()
        return e if e.startswith(".") else f".{e}"

    rgb_ext, depth_ext = norm_ext(args.encode_image), norm_ext(args.encode_depth)

    source = InputSource(str(input_path))
    mask = MaskSource(args.mask_path)
    if mask.has_loaded_mask:
        print(f"  using loaded mask: {args.mask_path}")

    crop = None
    if args.crop:
        from .demo_helpers.crop_ui import run_crop_ui

        init_frame = source.read_frame(0)
        assert init_frame is not None, "No frame available to crop"
        _, prev_crop = history.read("crop_xy1xy2_norm")
        _, crop_norm = run_crop_ui(init_frame, prev_crop)
        history.store(crop_xy1xy2_norm=crop_norm)
        crop = CropState(crop_norm)
        if not crop.is_cropping():
            crop = None

    # Warm up in the main thread before serving, so the first browser request
    # is not stuck behind the first inference: on a fresh checkout that one
    # builds the CUDA kernels with nvcc, and each size builds its aux once.
    probe = source.read_frame(0)
    if probe is not None:
        if crop is not None:
            probe = crop.apply(probe)
        print("Warming up (the first inference on the card builds the CUDA kernels with nvcc, which can take a "
              "minute)...", flush=True)
        predict_depth(model, probe, max_side, use_square)
        print("Ready.", flush=True)

    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(model, source, max_side, is_metric, mask=mask, crop=crop,
                     use_square=use_square, rgb_ext=rgb_ext, depth_ext=depth_ext),
    )
    url = f"http://{args.host}:{args.port}"
    print(f"\nServing 3D viewer at {url}\n(ctrl+c to quit)")
    if args.launch:
        import webbrowser

        threading.Timer(0.5, lambda: webbrowser.open(url)).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    server.server_close()


if __name__ == "__main__":
    main()
