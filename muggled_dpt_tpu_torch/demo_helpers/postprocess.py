"""Depth post-processing, the counterpart of JAX ``demo_helpers/postprocess.py``.

``scale_prediction`` resizes on the prediction's device with the port's
``ops/resize.py``; the rest is numpy on the host."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_2d


def scale_prediction(prediction_hw, output_wh):
    """Resize a (H, W) or (1, H, W) prediction (a tensor on any device, or a
    numpy array) to display size (w, h): bilinear, align_corners=False,
    computed in float32. Returns a float32 numpy array."""
    x = torch.as_tensor(prediction_hw).float()
    squeeze = x.dim() == 3
    if squeeze:
        x = x[0]
    out_w, out_h = int(output_wh[0]), int(output_wh[1])
    out = resize_2d(x[None, None], (out_h, out_w))[0, 0].cpu().numpy()
    return out[None] if squeeze else out


def remove_infinities(depth):
    """Replace +/-inf (and NaN) entries so normalization doesn't blow up:
    +inf by the finite max, -inf and NaN by the finite min."""
    arr = np.asarray(depth, dtype=np.float32).copy()
    finite = np.isfinite(arr)
    if finite.all():
        return arr
    if not finite.any():
        return np.zeros_like(arr)
    fmin, fmax = arr[finite].min(), arr[finite].max()
    arr[np.isposinf(arr)] = fmax
    arr[np.isneginf(arr)] = fmin
    arr[np.isnan(arr)] = fmin
    return arr


def normalize_01(depth):
    """Min-max normalize to [0, 1]."""
    arr = np.asarray(depth, dtype=np.float32)
    dmin, dmax = float(arr.min()), float(arr.max())
    if dmax - dmin < 1e-12:
        return np.zeros_like(arr)
    return (arr - dmin) / (dmax - dmin)


def convert_to_uint8(depth_norm_01):
    """[0, 1] float -> uint8."""
    arr = np.asarray(depth_norm_01, dtype=np.float32)
    return np.clip(arr * 255.0, 0, 255).astype(np.uint8)


def histogram_equalization(depth_uint8, min_pct: float = 0.0, max_pct: float = 1.0):
    """Thresholded histogram equalization by a CDF lookup table: values
    below/above the percentile thresholds clamp to 0/255, the rest is
    equalized by the empirical CDF."""
    img = np.asarray(depth_uint8, dtype=np.uint8)
    lo = int(round(255 * min_pct))
    hi = int(round(255 * max_pct))
    lo, hi = min(lo, hi), max(lo, hi)

    hist = np.bincount(img.reshape(-1), minlength=256).astype(np.float64)
    hist[:lo] = 0
    hist[hi + 1 :] = 0
    cdf = hist.cumsum()
    total = cdf[-1]
    if total <= 0:
        return np.zeros_like(img)
    lut = np.clip(np.round(255.0 * cdf / total), 0, 255).astype(np.uint8)
    lut[:lo] = 0
    lut[hi + 1 :] = 255
    return lut[img]
