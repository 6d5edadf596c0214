"""Video Depth Anything: Depth-Anything V2's patch embed, DINOv2 blocks and DPT
neck (``counts/depth_anything_v2.py``), plus four temporal motion modules.

A temporal module at width C over M tokens (the positions of its map times
the frames) has these products: ``proj_in``, ``proj_out``, and per attention
block ``to_q``, ``to_k``, ``to_v`` and ``to_out`` (each 2 M C C), then
``ff.net.0.proj`` (2 M 8C C) and ``ff.net.2`` (2 M C 4C): twelve, 44 M C^2,
with two attention blocks and GEGLU x4. Each attention block attends over the T
frames at each position: 4 T C operations a token (q k^T and p v, all
heads), with q, k, v read once and the output written once. The modules'
maps: the third reassembly map (the patch grid), the fourth after its
stride-2 resample, and refinenet4's and refinenet3's outputs, twice the
fourth's and the third's sides (each fusion block doubles its map).

``temporal``: the products and the attention of one forward of ``batch``
frames, with the least time as the sum over each product and each attention
block of ``peaks.bound_s`` (its operations at the dense peak, or its weight,
input and output moved once at HBM's rate, whichever is longer).
``attention`` holds the encoder's attention and the temporal attention, so
``attention.roofline_pct`` divides all the attention it times by all it
counts."""

from __future__ import annotations

from ..peaks import ELEMENT_BYTES, bound_s
from . import attention, conv, gemm, neck, vit_block


def module_grids(grid_hw) -> list:
    """(h, w) of each temporal module's map, in module order."""
    gh, gw = grid_hw
    down = ((gh + 1) // 2, (gw + 1) // 2)  # the fourth reassembly map: 3x3, stride 2, padding 1
    return [(gh, gw), down, (2 * down[0], 2 * down[1]), (2 * gh, 2 * gw)]


def temporal_parts(config: dict, grid_hw, batch: int) -> tuple[list, list]:
    """([(operations, bytes)] of each product, [(operations, bytes)] of each
    attention block) of one forward's temporal modules."""
    e = ELEMENT_BYTES[config["dtype"]]
    blocks, mult = config["temporal_attention_blocks"], config["temporal_ff_mult"]
    products, attn = [], []
    for c, (h, w) in zip(config["temporal_channels"], module_grids(grid_hw)):
        m = batch * h * w
        shapes = [(c, c)] * (2 + 4 * blocks) + [(2 * mult * c, c), (c, mult * c)]
        products += [(gemm(m, n_out, n_in), e * (n_out * n_in + m * n_in + m * n_out)) for n_out, n_in in shapes]
        attn += [(4.0 * batch * c * m, 4.0 * m * c * e)] * blocks  # T = batch: the forward is one clip
    return products, attn


def counts(config: dict, scaled_hw, batch: int) -> dict:
    """``tokens``, ``model_flops_per_frame``, ``attention`` and ``temporal``
    (one forward of ``batch`` frames, one clip) at ``scaled_hw``."""
    p, f = config["patch_size_px"], config["features_per_token"]
    grid = (scaled_hw[0] // p, scaled_hw[1] // p)
    n = grid[0] * grid[1] + 1
    products, attn = temporal_parts(config, grid, batch)
    parts = products + attn
    temporal = {"flops": sum(fl for fl, _ in parts), "bytes": sum(b for _, b in parts),
                "bound_s": sum(bound_s(fl, b, config["dtype"]) for fl, b in parts)}
    encoder_attention = attention(config, n, batch)
    t_attn = {"flops": sum(fl for fl, _ in attn), "bytes": sum(b for _, b in attn),
              "bound_s": sum(bound_s(fl, b, config["dtype"]) for fl, b in attn)}
    per_frame = (conv(f, 3, p, grid[0] * grid[1])
                 + config["num_blocks"] * vit_block(n, f, config["mlp_hidden"], config["num_heads"])
                 + neck(config, grid, scaled_hw) + temporal["flops"] / batch)
    return {"tokens": n, "model_flops_per_frame": per_frame,
            "attention": {k: encoder_attention[k] + t_attn[k] for k in ("flops", "bytes", "bound_s")},
            "temporal": temporal}
