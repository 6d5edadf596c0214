"""Depth-Anything V2 ViT-Giant in plain float32 PyTorch, from the original
checkpoint's keys (github.com/DepthAnything/Depth-Anything-V2
``depth_anything_v2/dpt.py`` with ``dinov2.py``'s ``vit_giant2``: patch 14,
width 1536, 40 blocks, 24 heads, LayerScale, ``ffn_layer="swiglufused"``).

Each block is pre-norm with LayerScale, both LayerNorms at eps 1e-6:
``x + ls1 * attn(LN1(x))``, then ``x + ls2 * w3(silu(a) * b)`` with ``a, b =
w12(LN2(x)).chunk(2)`` (``SwiGLUFFNFused``). The ViT-L reference's block
(``vit_block``) is GELU only, so the block is here; the preprocessing, the
position embedding and the neck are the ViT-L reference's, by import.

The one departure, shared with the system under test, so that ``correct``
cannot see it: the learned position embedding is resized to the patch grid
by size (bicubic, align_corners=False, no antialias), where DINOv2's
``interpolate_pos_encoding`` passes a scale factor with a 0.1 offset. The
taps, the end of each quarter (9, 19, 29, 39), are the published
``intermediate_layer_idx['vitg']``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import attention, conv2d, exact, fusion, head, linear, preprocess, resample, taps, tokens_to_map, weight
from .depth_anything_v2 import MEAN_RGB, RESAMPLE, STD_RGB, position_embedding


def swiglu_block(x, sd: dict, pre: str, heads: int, q=exact, eps: float = 1e-6) -> torch.Tensor:
    """One ViT-Giant block: x + ls1 * attn(LN1(x)); then + ls2 * w3(silu(a) * b), [a | b] = w12(LN2(x))."""
    h = F.layer_norm(x, (x.shape[-1],), weight(sd, f"{pre}.norm1.weight"), weight(sd, f"{pre}.norm1.bias"), eps)
    x = x + weight(sd, f"{pre}.ls1.gamma") * attention(
        h, weight(sd, f"{pre}.attn.qkv.weight"), weight(sd, f"{pre}.attn.qkv.bias"), weight(sd, f"{pre}.attn.proj.weight"),
        weight(sd, f"{pre}.attn.proj.bias"), heads, q=q)
    h = F.layer_norm(x, (x.shape[-1],), weight(sd, f"{pre}.norm2.weight"), weight(sd, f"{pre}.norm2.bias"), eps)
    a, b = linear(h, weight(sd, f"{pre}.mlp.w12.weight"), weight(sd, f"{pre}.mlp.w12.bias"), q).chunk(2, dim=-1)
    h = linear(F.silu(a) * b, weight(sd, f"{pre}.mlp.w3.weight"), weight(sd, f"{pre}.mlp.w3.bias"), q)
    return x + weight(sd, f"{pre}.ls2.gamma") * h


@torch.no_grad()
def forward(sd: dict, config: dict, frames_u8: torch.Tensor, scaled_hw, q=exact) -> torch.Tensor:
    """(B, H, W, 3) RGB uint8 frames -> (B, h, w) float32 depth at ``scaled_hw``;
    ``q`` rounds every product's operands (``exact``: none)."""
    heads = config["num_heads"]
    p = config["patch_size_px"]
    x = preprocess(frames_u8, scaled_hw, MEAN_RGB, STD_RGB)
    x = conv2d(x, weight(sd, "pretrained.patch_embed.proj.weight"), weight(sd, "pretrained.patch_embed.proj.bias"), q,
               stride=p)
    b, _, gh, gw = x.shape
    x = torch.cat([weight(sd, "pretrained.cls_token").expand(b, 1, -1), x.flatten(2).transpose(1, 2)], dim=1)
    x = x + position_embedding(sd, (gh, gw))
    outputs = []
    tapped = taps(config["num_blocks"])
    for i in range(config["num_blocks"]):
        x = swiglu_block(x, sd, f"pretrained.blocks.{i}", heads, q)
        if i in tapped:
            outputs.append(F.layer_norm(x, (x.shape[-1],), weight(sd, "pretrained.norm.weight"),
                                        weight(sd, "pretrained.norm.bias"), 1e-6))
    layers_rn = []
    for i, (t, scale) in enumerate(zip(outputs, RESAMPLE)):
        m = tokens_to_map(t[:, 1:], (gh, gw))  # readout 'ignore': the cls token is dropped
        m = conv2d(m, weight(sd, f"depth_head.projects.{i}.weight"), weight(sd, f"depth_head.projects.{i}.bias"), q)
        if scale != 1:
            m = resample(m, weight(sd, f"depth_head.resize_layers.{i}.weight"),
                         weight(sd, f"depth_head.resize_layers.{i}.bias"), scale, q)
        layers_rn.append(conv2d(m, weight(sd, f"depth_head.scratch.layer{i + 1}_rn.weight"), None, q, padding=1))
    path = fusion(layers_rn, sd, "depth_head.scratch.refinenet", q)
    return head(path, sd, "depth_head.scratch.output_conv1", "depth_head.scratch.output_conv2.0",
                "depth_head.scratch.output_conv2.2", scaled_hw, q)
