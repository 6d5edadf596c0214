"""DINOv2 image encoder for Depth-Anything V2.

The counterpart of ``muggled_dpt_tpu/models/dinov2.py``: cls token plus a
learned position embedding resized per patch grid (float32 bicubic, no
antialias), pre-norm blocks with LayerScale, the V2 stage taps (the output
after each quarter of the blocks) and one output norm shared by the four
taps. The blocks are an ``nn.ModuleList`` walked by a Python loop."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import layer_norm, mlp_gelu, self_attention
from ..ops.resize import resize_bicubic_hwc


def stage_taps(num_blocks: int) -> tuple[int, ...]:
    """V2: indices of the blocks whose outputs feed the DPT neck."""
    per = num_blocks // 4
    return tuple(per * (i + 1) - 1 for i in range(4))


class Attention(nn.Module):
    def __init__(self, features: int, device=None):
        super().__init__()
        self.qkv = nn.Linear(features, 3 * features, device=device)  # rows head-major
        self.proj = nn.Linear(features, features, device=device)


class Mlp(nn.Module):
    def __init__(self, features: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(features, hidden, device=device)
        self.fc2 = nn.Linear(hidden, features, device=device)


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale. BEiT's blocks are the same
    with an attention bias (``ops.nn.self_attention``'s ``bias``)."""

    def __init__(self, features: int, num_heads: int, use_kernel: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel = use_kernel
        self.norm1 = nn.LayerNorm(features, eps=1e-6, device=device)
        self.attn = Attention(features, device=device)
        self.ls1 = nn.Parameter(torch.empty(features, device=device))
        self.norm2 = nn.LayerNorm(features, eps=1e-6, device=device)
        self.mlp = Mlp(features, 4 * features, device=device)
        self.ls2 = nn.Parameter(torch.empty(features, device=device))

    def forward(self, tokens, bias=None):
        a = self.attn
        h = layer_norm(tokens, self.norm1.weight, self.norm1.bias)
        h = self_attention(h, a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, self.num_heads, self.use_kernel, bias)
        tokens = tokens + self.ls1 * h
        m = self.mlp
        h = layer_norm(tokens, self.norm2.weight, self.norm2.bias)
        h = mlp_gelu(h, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)
        return tokens + self.ls2 * h


class DinoV2Encoder(nn.Module):
    def __init__(self, features: int, num_heads: int, num_blocks: int, base_grid_hw, use_kernel: bool = True, device=None):
        super().__init__()
        self.features = features
        self.base_grid_hw = tuple(int(g) for g in base_grid_hw)
        self.taps = stage_taps(num_blocks)
        self.cls_token = nn.Parameter(torch.empty(1, 1, features, device=device))
        self.cls_embed = nn.Parameter(torch.empty(1, 1, features, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, self.base_grid_hw[0] * self.base_grid_hw[1], features, device=device))
        self.blocks = nn.ModuleList(Block(features, num_heads, use_kernel, device=device) for _ in range(num_blocks))
        self.outnorm = nn.LayerNorm(features, eps=1e-6, device=device)

    def resized_pos_embed(self, grid_hw):
        """(1, gh*gw, F) position embedding for a patch grid."""
        (bh, bw), (th, tw) = self.base_grid_hw, grid_hw
        if (th, tw) == (bh, bw):
            return self.pos_embed
        grid = resize_bicubic_hwc(self.pos_embed.reshape(bh, bw, -1), (th, tw))  # float32 inside
        return grid.reshape(1, th * tw, -1)

    def forward(self, patch_tokens, grid_hw):
        """patch_tokens: (B, N, F). Returns the 4 tapped (B, 1+N, F) token
        tensors, each through the shared output norm."""
        b = patch_tokens.shape[0]
        patch_tokens = patch_tokens + self.resized_pos_embed(grid_hw).to(patch_tokens.dtype)
        cls_tok = (self.cls_token + self.cls_embed).to(patch_tokens.dtype).expand(b, 1, self.features)
        tokens = torch.cat([cls_tok, patch_tokens], dim=1)
        outputs = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i in self.taps:
                outputs.append(tokens)
        return tuple(layer_norm(o, self.outnorm.weight, self.outnorm.bias) for o in outputs)
