"""Plane-of-best-fit ('floor removal'), the counterpart of JAX
``demo_helpers/plane_fit.py``: a jittered grid of depth samples is fit with a
plane (the SVD normal); the plane can be rendered as an image and subtracted
from the depth map to flatten a floor or wall that dominates the
relative-depth range."""

from __future__ import annotations

import numpy as np


def sample_depth_grid(depth_hw, num_x: int = 16, num_y: int = 16, jitter_scale: float = 0.75, rng=None):
    """Sample depth on a jittered num_x by num_y grid. Returns (xyz samples
    (N, 3) in pixel units, xyz mean (3,))."""
    depth = np.asarray(depth_hw, dtype=np.float32)
    h, w = depth.shape[:2]
    num_x, num_y = min(num_x, w), min(num_y, h)
    rng = rng or np.random.default_rng()
    jitter_scale = float(np.clip(jitter_scale, 0.0, 1.0))

    xs = (0.5 + np.arange(num_x)) / num_x
    ys = (0.5 + np.arange(num_y)) / num_y
    xg, yg = np.meshgrid(xs, ys)
    xg = xg + np.clip(rng.standard_normal(xg.shape), -1, 1) * (0.5 / num_x) * jitter_scale
    yg = yg + np.clip(rng.standard_normal(yg.shape), -1, 1) * (0.5 / num_y) * jitter_scale

    px = np.clip(np.round(xg * (w - 1)).astype(np.int32), 0, w - 1).ravel()
    py = np.clip(np.round(yg * (h - 1)).astype(np.int32), 0, h - 1).ravel()
    z = depth[py, px]
    xyz = np.stack([px.astype(np.float32), py.astype(np.float32), z], axis=1)
    xyz_mean = np.array([(w - 1) * 0.5, (h - 1) * 0.5, z.mean()], dtype=np.float32)
    return xyz, xyz_mean


def find_plane_normal(xyz_samples, xyz_mean=None):
    """Plane normal by the SVD of the mean-centred samples (the smallest
    singular vector), oriented so that its z component is positive."""
    xyz = np.asarray(xyz_samples, dtype=np.float64)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise TypeError(f"Expecting samples of shape [N, 3], got: {xyz.shape}")
    mean = xyz.mean(axis=0) if xyz_mean is None else np.asarray(xyz_mean, dtype=np.float64)
    _, _, vt = np.linalg.svd(xyz - mean, full_matrices=False)
    normal = vt[-1]
    if normal[2] < 0:
        normal = -normal
    return normal.astype(np.float32)


def make_plane_image(shape_hw, plane_normal, xyz_mean):
    """Render the fitted plane as a depth image: n . (p - mean) = 0 solved for z."""
    h, w = int(shape_hw[0]), int(shape_hw[1])
    nx, ny, nz = (float(v) for v in plane_normal)
    mx, my, mz = (float(v) for v in xyz_mean)
    if abs(nz) < 1e-9:
        return np.zeros((h, w), dtype=np.float32)
    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return mz - (nx * (xg - mx) + ny * (yg - my)) / nz


def estimate_plane_of_best_fit(depth_hw, num_x: int = 16, num_y: int = 16, jitter_scale: float = 0.75, rng=None):
    """Sample, fit and render in one call: a plane image of the depth's shape."""
    depth = np.asarray(depth_hw, dtype=np.float32)
    xyz, mean = sample_depth_grid(depth, num_x, num_y, jitter_scale, rng)
    normal = find_plane_normal(xyz, mean)
    return make_plane_image(depth.shape[:2], normal, mean)
