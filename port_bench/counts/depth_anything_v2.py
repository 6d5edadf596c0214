"""Depth-Anything V2: patch embed, the DINOv2 blocks (no bias on attention)
and the DPT neck with readout 'ignore'."""

from __future__ import annotations

from . import attention, conv, neck, vit_block


def counts(config: dict, scaled_hw, batch: int) -> dict:
    """``model_flops_per_frame`` and ``attention`` (one forward of ``batch`` frames) at ``scaled_hw``."""
    p, f = config["patch_size_px"], config["features_per_token"]
    grid = (scaled_hw[0] // p, scaled_hw[1] // p)
    n = grid[0] * grid[1] + 1
    per_frame = (conv(f, 3, p, grid[0] * grid[1])
                 + config["num_blocks"] * vit_block(n, f, config["mlp_hidden"], config["num_heads"])
                 + neck(config, grid, scaled_hw))
    return {"tokens": n, "model_flops_per_frame": per_frame, "attention": attention(config, n, batch)}
