"""Result export, the counterpart of JAX ``demo_helpers/saving.py``:
timestamped names, colour PNG, raw .npy and normalized uint16 PNG."""

from __future__ import annotations

import os
import os.path as osp
from datetime import datetime

import cv2
import numpy as np

from .postprocess import normalize_01, remove_infinities


def make_save_name(source_path: str | None = None, tag: str = "depth") -> str:
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    base = osp.splitext(osp.basename(source_path))[0] if source_path else tag
    return f"{base}_{stamp}"


def get_save_folder(save_folder: str | None = None) -> str:
    folder = save_folder or osp.join(os.getcwd(), "saved_results")
    os.makedirs(folder, exist_ok=True)
    return folder


def save_image(image_bgr: np.ndarray, save_name: str, save_folder: str | None = None) -> str | None:
    """Save a display (colour) image as PNG. Returns the path, or None on failure."""
    path = osp.join(get_save_folder(save_folder), f"{save_name}.png")
    try:
        ok = cv2.imwrite(path, image_bgr)
        return path if ok else None
    except cv2.error:
        return None


def save_numpy_array(depth_prediction, save_name: str, save_folder: str | None = None) -> str:
    """Save the raw (float32) depth prediction as .npy."""
    path = osp.join(get_save_folder(save_folder), f"{save_name}.npy")
    np.save(path, np.asarray(depth_prediction, dtype=np.float32))
    return path


def save_uint16_png(depth_prediction, save_name: str, save_folder: str | None = None) -> str:
    """Save a normalized 16-bit PNG of the depth prediction."""
    depth = normalize_01(remove_infinities(np.asarray(depth_prediction, np.float32)))
    depth_u16 = np.round(depth * np.iinfo(np.uint16).max).astype(np.uint16)
    path = osp.join(get_save_folder(save_folder), f"{save_name}.png")
    cv2.imwrite(path, depth_u16)
    return path
