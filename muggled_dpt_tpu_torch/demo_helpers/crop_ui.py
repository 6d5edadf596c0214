"""Interactive crop-box UI (reference demo_helpers/crop_ui.py): drag a
rectangle over the image; returns row/col slices + normalized coordinates so
the crop can be persisted in history and re-applied.

The port's copy of the JAX package's ``demo_helpers/crop_ui.py`` (that package
imports jax), unchanged but for this note."""

from __future__ import annotations

import cv2
import numpy as np


def norm_crop_to_slices(img_hw, xy1xy2_norm):
    """Normalized ((x1,y1),(x2,y2)) crop -> (y_slice, x_slice) for a frame of
    shape img_hw (shared by the crop UI and the headless persisted-crop path)."""
    h, w = int(img_hw[0]), int(img_hw[1])
    (x1n, y1n), (x2n, y2n) = xy1xy2_norm
    y_slice = slice(int(round(y1n * h)), max(int(round(y2n * h)), int(round(y1n * h)) + 1))
    x_slice = slice(int(round(x1n * w)), max(int(round(x2n * w)), int(round(x1n * w)) + 1))
    return (y_slice, x_slice)


def run_crop_ui(image_bgr: np.ndarray, initial_xy1xy2_norm=None, window_title="Crop - drag box, ENTER to accept"):
    """Blocking crop selection. Returns ((y_slice, x_slice), xy1xy2_norm)."""
    h, w = image_bgr.shape[:2]
    scale = min(1.0, 900 / max(h, w))
    disp = cv2.resize(image_bgr, None, fx=scale, fy=scale) if scale < 1.0 else image_bgr.copy()
    dh, dw = disp.shape[:2]

    state = {"drag": False, "p0": None, "p1": None}
    if initial_xy1xy2_norm:
        (x1n, y1n), (x2n, y2n) = initial_xy1xy2_norm
        state["p0"] = (int(x1n * dw), int(y1n * dh))
        state["p1"] = (int(x2n * dw), int(y2n * dh))

    def on_mouse(event, x, y, flags, _param):
        if event == cv2.EVENT_LBUTTONDOWN:
            state.update(drag=True, p0=(x, y), p1=(x, y))
        elif event == cv2.EVENT_MOUSEMOVE and state["drag"]:
            state["p1"] = (x, y)
        elif event == cv2.EVENT_LBUTTONUP:
            state.update(drag=False, p1=(x, y))

    cv2.namedWindow(window_title)
    cv2.setMouseCallback(window_title, on_mouse)
    try:
        while True:
            frame = disp.copy()
            if state["p0"] and state["p1"]:
                cv2.rectangle(frame, state["p0"], state["p1"], (90, 160, 255), 2)
            cv2.imshow(window_title, frame)
            key = cv2.waitKey(16) & 0xFF
            if key in (13, 10, 32):  # enter / space accepts
                break
            if key in (27, ord("q")):  # esc cancels -> full image
                state["p0"], state["p1"] = None, None
                break
    finally:
        cv2.destroyWindow(window_title)

    if not state["p0"] or not state["p1"] or state["p0"] == state["p1"]:
        xy1xy2_norm = ((0.0, 0.0), (1.0, 1.0))
    else:
        (x0, y0), (x1, y1) = state["p0"], state["p1"]
        x0, x1 = sorted((x0, x1))
        y0, y1 = sorted((y0, y1))
        xy1xy2_norm = ((x0 / dw, y0 / dh), (x1 / dw, y1 / dh))

    return norm_crop_to_slices((h, w), xy1xy2_norm), xy1xy2_norm


def apply_crop(image_bgr: np.ndarray, xy1xy2_norm) -> np.ndarray:
    """Re-apply a stored normalized crop box."""
    h, w = image_bgr.shape[:2]
    (x1n, y1n), (x2n, y2n) = xy1xy2_norm
    ys = slice(int(round(y1n * h)), max(int(round(y2n * h)), int(round(y1n * h)) + 1))
    xs = slice(int(round(x1n * w)), max(int(round(x2n * w)), int(round(x1n * w)) + 1))
    return image_bgr[ys, xs]
