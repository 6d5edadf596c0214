"""MiDaS v3.1 BEiT: patch embed, the BEiT blocks, whose attention reads one
layer of the relative-position bias, and the DPT neck with readout
'project' (a 2F -> F linear per stage)."""

from __future__ import annotations

from . import attention, conv, gemm, neck, vit_block


def counts(config: dict, scaled_hw, batch: int) -> dict:
    """``model_flops_per_frame`` and ``attention`` (one forward of ``batch`` frames) at ``scaled_hw``."""
    p, f = config["patch_size_px"], config["features_per_token"]
    grid = (scaled_hw[0] // p, scaled_hw[1] // p)
    n = grid[0] * grid[1] + 1
    per_frame = (conv(f, 3, p, grid[0] * grid[1])
                 + config["num_blocks"] * vit_block(n, f, config["mlp_hidden"], config["num_heads"])
                 + 4 * gemm(n - 1, f, 2 * f)
                 + neck(config, grid, scaled_hw))
    bias = config["num_heads"] * n * n  # the layer's (H, N, N) bias, read once per forward
    return {"tokens": n, "model_flops_per_frame": per_frame, "attention": attention(config, n, batch, bias)}
