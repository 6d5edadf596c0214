"""Server-side depth-mesh export (OBJ / binary glTF), mirroring the browser
client's mesh math exactly (viewer3d/viewer.js:buildMeshArrays/exportOBJ/
exportGLB; reference analogs 3dviewer/save_obj.js and save_gltf.js).

Two purposes:
1. Headless export: `run_3dviewer.py` serves /export/obj and /export/glb so
   meshes can be pulled with curl — no browser required.
2. Executable verification of the export logic: no JS engine exists in the
   CI image, so the byte-level GLB layout (12-byte header + aligned
   JSON/BIN chunks), the OBJ grammar, the grid sampling and the triangle
   winding are pinned here by tests (tests/test_3dviewer_server.py) against
   the same formulas the JS uses — vertex (u-0.5)*aspect / 0.5-v / A*d+B,
   nearest-neighbor depth sampling, winding (i0, i2, i1), (i1, i2, i3).

The port's copy of the JAX package's ``demo_helpers/mesh_export.py`` (that package
imports jax), unchanged but for this note."""

from __future__ import annotations

import json
import struct

import numpy as np


def build_mesh_arrays(depth_01: np.ndarray, grid: int = 320, scale: float = 0.6, offset: float = 0.0,
                      dmin: float = 0.0, dmax: float = 1.0):
    """(GRID+1)^2 displaced-plane mesh from a normalized depth map.

    Mirrors viewer.js:buildMeshArrays (positions) and buildGrid (uvs,
    indices): uv-regular vertex grid, nearest-neighbor depth sample,
    min/max depth-range remap (viewer.js:remapDepth — clamp((d-dmin)/(dmax-
    dmin))), z = scale * depth + offset, x spans the image aspect ratio.
    Returns (positions (n,3) f32, uvs (n,2) f32, indices (m,3) u32)."""
    h, w = depth_01.shape
    aspect = w / h
    side = grid + 1
    u = np.arange(side, dtype=np.float32) / grid
    v = np.arange(side, dtype=np.float32) / grid
    uu, vv = np.meshgrid(u, v)  # row-major: vertex i = y*(grid+1)+x
    # half-UP rounding to match JS Math.round (np.round is half-to-even and
    # would pick a different pixel at exact .5 sample coordinates)
    px = np.minimum(w - 1, np.floor(uu * (w - 1) + 0.5).astype(np.int64))
    py = np.minimum(h - 1, np.floor(vv * (h - 1) + 0.5).astype(np.int64))
    d = depth_01[py, px].astype(np.float32)
    if not (np.isfinite(dmin) and np.isfinite(dmax)):
        dmin, dmax = 0.0, 1.0  # non-finite range would NaN every vertex
    if (dmin, dmax) != (0.0, 1.0):
        lo, hi = (dmin, dmax) if dmin < dmax else (dmax, dmin)
        d = np.clip((d - lo) / max(hi - lo, 0.001), 0.0, 1.0)
    positions = np.stack(
        [(uu - 0.5) * aspect, 0.5 - vv, scale * d + offset], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)

    # two triangles per cell, winding (i0, i2, i1), (i1, i2, i3) (viewer.js:141-146)
    ys, xs = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    i0 = (ys * side + xs).ravel()
    i1 = i0 + 1
    i2 = i0 + side
    i3 = i2 + 1
    indices = np.stack([i0, i2, i1, i1, i2, i3], axis=-1).reshape(-1, 3).astype(np.uint32)
    return positions, uvs, indices


def export_obj(depth_01: np.ndarray, grid: int = 320, scale: float = 0.6, offset: float = 0.0,
               dmin: float = 0.0, dmax: float = 1.0) -> bytes:
    """Wavefront OBJ with v/vt/f records (viewer.js:exportOBJ; flipped vt v)."""
    positions, uvs, indices = build_mesh_arrays(depth_01, grid, scale, offset, dmin, dmax)
    lines = ["# muggled_dpt_tpu depth mesh"]
    lines += [f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}" for p in positions]
    lines += [f"vt {t[0]:.5f} {1.0 - t[1]:.5f}" for t in uvs]
    for a, b, c in indices + 1:
        lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
    return "\n".join(lines).encode()


def export_glb(depth_01: np.ndarray, grid: int = 320, scale: float = 0.6, offset: float = 0.0,
               dmin: float = 0.0, dmax: float = 1.0) -> bytes:
    """Binary glTF 2.0 (GLB): 12-byte header + 4-aligned JSON chunk + BIN
    chunk holding positions|uvs|indices (viewer.js:exportGLB layout)."""
    positions, uvs, indices = build_mesh_arrays(depth_01, grid, scale, offset, dmin, dmax)
    pos_b, uv_b, idx_b = positions.tobytes(), uvs.tobytes(), indices.tobytes()
    bin_len = len(pos_b) + len(uv_b) + len(idx_b)
    bin_chunk = pos_b + uv_b + idx_b + b"\x00" * ((4 - bin_len % 4) % 4)

    gltf = {
        "asset": {"version": "2.0", "generator": "muggled_dpt_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2}]}],
        "accessors": [
            {
                "bufferView": 0,
                "componentType": 5126,
                "count": len(positions),
                "type": "VEC3",
                "min": positions.min(axis=0).tolist(),
                "max": positions.max(axis=0).tolist(),
            },
            {"bufferView": 1, "componentType": 5126, "count": len(uvs), "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": int(indices.size), "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_b)},
            {"buffer": 0, "byteOffset": len(pos_b), "byteLength": len(uv_b)},
            {"buffer": 0, "byteOffset": len(pos_b) + len(uv_b), "byteLength": len(idx_b)},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    json_bytes = json.dumps(gltf, separators=(",", ":")).encode()
    json_bytes += b" " * ((4 - len(json_bytes) % 4) % 4)

    total = 12 + 8 + len(json_bytes) + 8 + len(bin_chunk)
    out = bytearray()
    out += struct.pack("<III", 0x46546C67, 2, total)  # 'glTF', version 2
    out += struct.pack("<II", len(json_bytes), 0x4E4F534A) + json_bytes  # 'JSON'
    out += struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk  # 'BIN'
    return bytes(out)
