"""MiDaS v3.1 SwinV2: the patch embed, the four stages of window-attention
blocks with the patch merges between them, and the DPT neck of a
hierarchical encoder: a 3x3 fuse convolution from each stage's own width at
its own grid (no readout, projection or resample), the four fusion blocks
at those grids, and the head at 2x.

Per block on one frame of T tokens at width C: 2 T C (3C + C + 8C) in the
qkv, proj, fc1 and fc2 GEMMs, and 4 nW H A^2 D in the window attention (A
tokens a window, nW windows, H heads of D). The attention's bytes are q, k,
v and out, the block's (H, A, A) position bias and, on a shifted block, the
(nW, A, A) mask, each moved once in the configuration's type. The window
plan is the reference's (``reference/swinv2.py:window_and_shift``)."""

from __future__ import annotations

from ..peaks import ELEMENT_BYTES, bound_s
from ..reference.swinv2 import window_and_shift
from . import conv, gemm


def stages(config: dict, scaled_hw) -> list:
    """Per stage: (grid (h, w), width, heads, blocks, (wh, ww), shifts)."""
    p = config["patch_size_px"]
    h, w = scaled_hw[0] // p, scaled_hw[1] // p
    out = []
    for s, (f, heads, blocks) in enumerate(zip(config["features_per_stage"], config["heads_per_stage"],
                                               config["layers_per_stage"])):
        gh, gw = h >> s, w >> s
        (wh, sh), (ww, sw) = (window_and_shift(g, config["window_size_hw"][i]) for i, g in enumerate((gh, gw)))
        out.append(((gh, gw), f, heads, blocks, (wh, ww), bool(sh or sw)))
    return out


def neck(config: dict, grids: list, out_hw) -> float:
    """The fuse convolutions at each stage's grid, the fusion blocks at those
    sizes (two residual units but the top one, each two 3x3 convolutions,
    then a 1x1 convolution at twice the side) and the head (3x3 C -> C/2 at
    the fused map, 3x3 -> 32 and 1x1 -> 1 at the output) on one frame."""
    cf = config["fusion_channels"]
    total = 0.0
    for i, ((gh, gw), f) in enumerate(zip(grids, config["features_per_stage"])):
        g = gh * gw
        total += conv(cf, f, 3, g)
        total += (1 if i == 3 else 2) * 2 * conv(cf, cf, 3, g) + conv(cf, cf, 1, 4 * g)
    fused = 4 * grids[0][0] * grids[0][1]
    h, w = out_hw
    return total + conv(cf // 2, cf, 3, fused) + conv(32, cf // 2, 3, h * w) + conv(1, 32, 1, h * w)


def counts(config: dict, scaled_hw, batch: int) -> dict:
    """``tokens`` (the first stage's), ``model_flops_per_frame`` and
    ``attention`` (one forward of ``batch`` frames) at ``scaled_hw``."""
    dtype = config["dtype"]
    plan = stages(config, scaled_hw)
    p = config["patch_size_px"]
    (g0h, g0w), f0 = plan[0][0], plan[0][1]
    per_frame = conv(f0, 3, p, g0h * g0w)
    flops = nbytes = bound = 0.0
    for s, ((gh, gw), f, heads, blocks, (wh, ww), shifts) in enumerate(plan):
        t = gh * gw
        if s:
            per_frame += gemm(t, f, 2 * f)  # the merge into this stage: 4 C_prev = 2 C -> C
        a, nw, d = wh * ww, t // (wh * ww), f // heads
        block_flops = 4.0 * batch * nw * heads * a * a * d
        per_frame += blocks * (2.0 * t * f * 12 * f + block_flops / batch)
        for i in range(blocks):
            masked = shifts and i % 2 == 1
            block_bytes = (4 * batch * t * f + heads * a * a + (nw * a * a if masked else 0)) * ELEMENT_BYTES[dtype]
            flops, nbytes = flops + block_flops, nbytes + block_bytes
            bound += bound_s(block_flops, block_bytes, dtype)
    per_frame += neck(config, [grid for grid, *_ in plan], scaled_hw)
    return {"tokens": g0h * g0w, "model_flops_per_frame": per_frame,
            "attention": {"flops": flops, "bytes": nbytes, "bound_s": bound}}
