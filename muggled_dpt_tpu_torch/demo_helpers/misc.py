"""Device and dtype policy of the apps, depth read-back and the
dispatch-ahead gate of run_video: the counterpart of JAX
``demo_helpers/misc.py`` on torch.

The apps build on the CUDA card unless ``-d cpu`` asks for the CPU, and
raise without a card (``dpt.resolve_device``): they never fall back to the
CPU. The JAX package's ``select_device`` and ``enable_compilation_cache``
are JAX config switches with no counterpart here.

``AsyncResult`` is the dispatch-ahead gate: on the card it queues a frame's
upload, the forward and the depth's copy back on a CUDA stream of its own and
records an event after them, so the video loop polls ``event.query()``
where the JAX package polls ``jax.Array.is_ready()``."""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..dpt import resolve_device

DEVICE_HELP = "Device to run on (default: the CUDA card, which must exist; 'cpu' for the CPU)"


def run_with_backend_watchdog(fn, timeout_s: float = 60.0, what: str = "CUDA init"):
    """Run ``fn()`` (a call expected to touch the card for the first time)
    with a watchdog thread that prints an actionable hint if it blocks past
    ``timeout_s``. The watchdog is passive: it never touches the card
    itself, so a run that exits early (bad checkpoint path, Ctrl+C at a
    prompt) has not initialized CUDA at all."""
    done = threading.Event()

    def _watchdog():
        if not done.wait(timeout_s):
            print(
                f"*** {what} has not completed after {timeout_s:.0f}s — the card may be "
                "unreachable (busy, or its CUDA setup broken?). Exit and retry with '-d cpu' to run on the CPU.",
                flush=True,
            )

    threading.Thread(target=_watchdog, daemon=True).start()
    try:
        return fn()
    finally:
        done.set()


def make_device_config(device_str: str | None = None, use_float32: bool = False, prefer_bfloat16: bool = True) -> dict:
    """Compute policy of the apps' ``-d``, ``-f32`` and ``-u`` flags: the
    device (None: the CUDA card, resolved under the watchdog, raising without
    one) and the dtype, float32 on the CPU or when forced, else on the card
    bfloat16, or float16 for ``prefer_bfloat16=False`` (``-u``), as the JAX
    package's ``make_device_config``."""
    device = run_with_backend_watchdog(lambda: resolve_device(device_str))
    if use_float32 or device.type == "cpu":
        dtype = torch.float32
    else:
        dtype = torch.bfloat16 if prefer_bfloat16 else torch.float16
    return {"device": device, "dtype": dtype}


def maybe_quantize_int8(model, int8: bool, int8_full: bool = False):
    """Shared --int8 / --int8-full CLI handling for the apps: apply the int8
    serving tier (optionally incl. the full neck) with the standard
    unsupported-family fallback message. Returns the (possibly new) model."""
    if not (int8 or int8_full):
        return model
    try:
        model = model.quantize_encoder_int8(include_neck=int8_full)
        print("  int8 encoder tier enabled" + (" (+ full neck)" if int8_full else ""))
    except NotImplementedError as e:
        print(f"  --int8 unavailable for this family ({e}); using dense path")
    return model


def print_config_feedback(model_path: str, device_config: dict, use_cache: bool) -> None:
    """Startup feedback: model, device, dtype, cache, and on the card the
    memory the process holds against the card's total."""
    import os.path as osp

    device = torch.device(device_config.get("device"))
    lines = [
        "",
        f"Model: {osp.basename(model_path)}",
        f"Device: {device} | dtype: {str(device_config.get('dtype')).replace('torch.', '')} | cache: {use_cache}",
    ]
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        lines.append(f"Device memory: {torch.cuda.memory_allocated(device) / 1e9:.2f} / {total / 1e9:.2f} GB")
    print(*lines, sep="\n", flush=True)


def depth_to_numpy(depth: torch.Tensor) -> np.ndarray:
    """A depth prediction on any device, in any dtype, as a float32 numpy
    array (numpy takes neither a CUDA tensor nor bfloat16)."""
    return depth.detach().float().cpu().numpy()


def reduce_overthreading() -> None:
    """Cap cv2/BLAS thread pools for interactive use (reference misc.py:143-168)."""
    try:
        import cv2

        cv2.setNumThreads(max(2, (os.cpu_count() or 4) // 2))
    except Exception:
        pass


class AsyncResult:
    """Dispatch-ahead inference for the video loop (the reference's
    DeviceChecker CUDA-stream query, misc.py:19-38; JAX: ``is_ready`` of the
    in-flight array).

    On the card, ``dispatch`` queues on the gate's own ``torch.cuda.Stream``:
    the frame's host-to-device copy from a pinned staging buffer, the
    forward (``inference_rgb_device``), the depth's copy into pinned host
    memory, and an event after it. ``is_ready`` is ``event.query()``,
    ``wait`` and ``collect`` wait on the event. The staging buffer is
    rewritten only after the event that follows its last copy. On the CPU
    the forward runs in ``dispatch`` and the result is ready at once.

    ``dispatch`` returns once the host has queued the work, so its time is
    the host's share of a frame: with the eager forward, as long as queueing
    every launch takes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._staging = None  # pinned uint8 RGB frame
        self._uploaded = None  # event after the staging buffer's last copy
        self._pending = None  # (event or None, depth on the host)

    def is_ready(self) -> bool:
        event = self._pending[0] if self._pending is not None else None
        return event is None or event.query()

    def _upload(self, frame_bgr: np.ndarray) -> torch.Tensor:
        rgb = frame_bgr[..., ::-1]
        if not self._cuda:
            return torch.from_numpy(np.ascontiguousarray(rgb))
        if self._uploaded is not None:
            self._uploaded.synchronize()  # never rewrite the buffer under a copy in flight
        if self._staging is None or tuple(self._staging.shape) != rgb.shape:
            self._staging = torch.empty(rgb.shape, dtype=torch.uint8, pin_memory=True)
        np.copyto(self._staging.numpy(), rgb)
        frame = self._staging.to(self.device, non_blocking=True)
        self._uploaded = torch.cuda.Event()
        self._uploaded.record(self._stream)
        return frame

    def dispatch(self, model, frame_bgr: np.ndarray, max_side_length=None, use_square_sizing: bool = True) -> None:
        """Queue the inference of one BGR uint8 frame, as ``model.inference``
        computes it; the result waits for ``collect``."""
        scaled_hw = model.compute_scaled_hw(frame_bgr.shape[:2], max_side_length, use_square_sizing)
        if not self._cuda:
            self._pending = None, model.inference_rgb_device(self._upload(frame_bgr), scaled_hw)
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))  # the weights, written on the caller's stream
        with torch.cuda.stream(self._stream):
            depth = model.inference_rgb_device(self._upload(frame_bgr), scaled_hw)
            host = torch.empty(depth.shape, dtype=depth.dtype, pin_memory=True)
            host.copy_(depth, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._pending = done, host

    def wait(self) -> None:
        """Block until the last dispatched result is on the host."""
        if self._pending is not None and self._pending[0] is not None:
            self._pending[0].synchronize()

    def collect(self):
        """The last dispatched depth as float32 numpy (waiting for it), once;
        None when nothing is pending."""
        if self._pending is None:
            return None
        self.wait()
        _, depth = self._pending
        self._pending = None
        return depth_to_numpy(depth)
