"""Operations and bytes of a forward, from the configuration's widths and the
cell's shapes: one file per family (``<family>.py``: ``counts(config,
scaled_hw, batch)``), and here the arithmetic they share. GEMMs count 2 M N K,
attention 4 B H N^2 D (q k^T and p v), a convolution 2 Cout Cin k^2 per output
pixel (a transposed one per input pixel); elementwise work is not counted."""

from __future__ import annotations

from ..peaks import ELEMENT_BYTES, bound_s

REASSEMBLY_SCALES = (4, 2, 1, 0.5)


def gemm(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def conv(cout: int, cin: int, k: int, out_pixels: int) -> float:
    return 2.0 * cout * cin * k * k * out_pixels


def vit_block(n_tokens: int, features: int, hidden: int, heads: int) -> float:
    """One ViT block on one frame: qkv, proj, fc1, fc2 and attention."""
    d = features // heads
    return (gemm(n_tokens, 3 * features, features) + gemm(n_tokens, features, features)
            + 2 * gemm(n_tokens, hidden, features) + 4.0 * heads * n_tokens * n_tokens * d)


def neck(config: dict, grid_hw, out_hw) -> float:
    """DPT reassembly (1x1 projection, resample, 3x3 conv), the four fusion
    blocks and the head, on one frame."""
    f = config["features_per_token"]
    cf = config["fusion_channels"]
    gh, gw = grid_hw
    g = gh * gw
    total = 0.0
    sizes = []
    for r, s in zip(config["reassembly_features_list"], REASSEMBLY_SCALES):
        total += conv(r, f, 1, g)
        if s in (4, 2):
            total += conv(r, r, s, g)  # transposed, stride = kernel: per input pixel
            hw = (gh * s) * (gw * s)
        elif s == 0.5:
            hw = ((gh + 1) // 2) * ((gw + 1) // 2)
            total += conv(r, r, 3, hw)
        else:
            hw = g
        total += conv(cf, r, 3, hw)
        sizes.append(hw)
    for i, hw in enumerate(sizes):  # fusion block i works at the size of reassembly map i
        units = 1 if i == 3 else 2
        total += units * 2 * conv(cf, cf, 3, hw) + conv(cf, cf, 1, 4 * hw)
    fused = 4 * sizes[0]
    h, w = out_hw
    total += conv(cf // 2, cf, 3, fused) + conv(32, cf // 2, 3, h * w) + conv(1, 32, 1, h * w)
    return total


def attention(config: dict, n_tokens: int, batch: int, bias_per_layer: int = 0) -> dict:
    """A forward's attention over all blocks: operations, bytes (q, k, v
    read, out written, a bias of ``bias_per_layer`` elements read once per
    block) and the least time on the card."""
    heads, f, layers = config["num_heads"], config["features_per_token"], config["num_blocks"]
    d = f // heads
    flops = 4.0 * batch * heads * n_tokens * n_tokens * d
    nbytes = (4 * batch * n_tokens * f + bias_per_layer) * ELEMENT_BYTES[config["dtype"]]
    return {"flops": layers * flops, "bytes": layers * nbytes, "bound_s": layers * bound_s(flops, nbytes, config["dtype"])}
