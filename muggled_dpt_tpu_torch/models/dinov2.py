"""DINOv2 image encoder for Depth-Anything V1 and V2.

The counterpart of ``muggled_dpt_tpu/models/dinov2.py``: cls token plus a
learned position embedding resized per patch grid (float32 bicubic, no
antialias), pre-norm blocks with LayerScale (a GELU MLP, or SwiGLU for
ViT-Giant), four taps (V2: the output after each quarter of the blocks; V1:
the last four blocks) and one output norm shared by the four taps. The
blocks are an ``nn.ModuleList`` walked by a Python loop."""

from __future__ import annotations

import torch
from torch import nn

from ..checkpoints.random_init import swiglu_hidden
from ..ops.nn import layer_norm, mlp_gelu, mlp_swiglu, self_attention
from ..ops.resize import resize_bicubic_hwc
from ..utils.observability import trace_span


def stage_taps(num_blocks: int) -> tuple[int, ...]:
    """V2: indices of the blocks whose outputs feed the DPT neck."""
    per = num_blocks // 4
    return tuple(per * (i + 1) - 1 for i in range(4))


def last4_taps(num_blocks: int) -> tuple[int, ...]:
    """V1: the outputs of the last 4 consecutive blocks feed the DPT neck."""
    return tuple(range(num_blocks - 4, num_blocks))


class Attention(nn.Module):
    model_group = None  # tensor parallelism: the model group of a split qkv/proj pair (parallel/tensor.py)

    def __init__(self, features: int, device=None):
        super().__init__()
        self.qkv = nn.Linear(features, 3 * features, device=device)  # rows head-major
        self.proj = nn.Linear(features, features, device=device)

    def key_bias_mask(self, num_heads: int) -> torch.Tensor:
        """The k entries of the head-major qkv bias ([head][q|k|v][dim]), as a boolean mask."""
        mask = torch.zeros(num_heads, 3, self.qkv.out_features // (3 * num_heads), dtype=torch.bool,
                           device=self.qkv.bias.device)
        mask[:, 1] = True
        return mask.reshape(-1)


class Mlp(nn.Module):
    model_group = None  # tensor parallelism: the model group of a split fc1/fc2 pair

    def __init__(self, features: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(features, hidden, device=device)
        self.fc2 = nn.Linear(hidden, features, device=device)

    def forward(self, x):
        return mlp_gelu(x, self.fc1, self.fc2, self.model_group)


class SwiGLUMlp(nn.Module):
    """ViT-Giant's MLP: ``w12`` (2 * hidden, F) holds both gate halves.
    ``use_kernel``: the gate on ``swiglu_gate`` (the block's setting)."""

    model_group = None  # tensor parallelism: the model group of a split w12/w3 pair

    def __init__(self, features: int, hidden: int, use_kernel: bool = True, device=None):
        super().__init__()
        self.use_kernel = use_kernel
        self.w12 = nn.Linear(features, 2 * hidden, device=device)
        self.w3 = nn.Linear(hidden, features, device=device)

    def forward(self, x):
        return mlp_swiglu(x, self.w12, self.w3, self.model_group, self.use_kernel)


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale. BEiT's blocks are the same
    with an attention bias (``ops.nn.self_attention``'s ``bias``); ViT-Giant's
    have a SwiGLU MLP (``is_giant``)."""

    def __init__(self, features: int, num_heads: int, use_kernel: bool = True, is_giant: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel = use_kernel
        self.norm1 = nn.LayerNorm(features, eps=1e-6, device=device)
        self.attn = Attention(features, device=device)
        self.ls1 = nn.Parameter(torch.empty(features, device=device))
        self.norm2 = nn.LayerNorm(features, eps=1e-6, device=device)
        if is_giant:
            self.mlp = SwiGLUMlp(features, swiglu_hidden(features), use_kernel, device=device)
        else:
            self.mlp = Mlp(features, 4 * features, device=device)
        self.ls2 = nn.Parameter(torch.empty(features, device=device))

    def attention_residual(self, tokens, bias=None):
        """The first half: tokens + ls1 * attention(norm1(tokens))."""
        a = self.attn
        h = layer_norm(tokens, self.norm1.weight, self.norm1.bias)
        h = self_attention(h, a.qkv, a.proj, self.num_heads, self.use_kernel, bias, group=a.model_group)
        return tokens + self.ls1 * h

    def mlp_residual(self, tokens):
        """The second half: tokens + ls2 * mlp(norm2(tokens)), in an ``mlp``
        span. For a GELU MLP this is what ``ops/kernels/fused_mlp.py``
        computes in one kernel."""
        with trace_span("mlp"):
            return tokens + self.ls2 * self.mlp(layer_norm(tokens, self.norm2.weight, self.norm2.bias))

    def forward(self, tokens, bias=None):
        return self.mlp_residual(self.attention_residual(tokens, bias))

    def forward_capture(self, tokens, bias=None):
        """The block on the plain attention path that keeps the softmax
        weights: (tokens, (B, H, N, N) float32 weights)."""
        a = self.attn
        h = layer_norm(tokens, self.norm1.weight, self.norm1.bias)
        h, weights = self_attention(h, a.qkv, a.proj, self.num_heads, bias=bias, capture=True, group=a.model_group)
        return self.mlp_residual(tokens + self.ls1 * h), weights


class DinoV2Encoder(nn.Module):
    def __init__(self, features: int, num_heads: int, num_blocks: int, base_grid_hw, use_kernel: bool = True,
                 is_giant: bool = False, taps=None, device=None):
        super().__init__()
        self.features = features
        self.base_grid_hw = tuple(int(g) for g in base_grid_hw)
        self.taps = stage_taps(num_blocks) if taps is None else tuple(taps)
        self.cls_token = nn.Parameter(torch.empty(1, 1, features, device=device))
        self.cls_embed = nn.Parameter(torch.empty(1, 1, features, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, self.base_grid_hw[0] * self.base_grid_hw[1], features, device=device))
        self.blocks = nn.ModuleList(Block(features, num_heads, use_kernel, is_giant, device=device) for _ in range(num_blocks))
        self.outnorm = nn.LayerNorm(features, eps=1e-6, device=device)

    def resized_pos_embed(self, grid_hw):
        """(1, gh*gw, F) position embedding for a patch grid."""
        (bh, bw), (th, tw) = self.base_grid_hw, grid_hw
        if (th, tw) == (bh, bw):
            return self.pos_embed
        grid = resize_bicubic_hwc(self.pos_embed.reshape(bh, bw, -1), (th, tw))  # float32 inside
        return grid.reshape(1, th * tw, -1)

    def embed(self, patch_tokens, grid_hw):
        """(B, N, F) patch tokens -> (B, 1+N, F): the grid's position
        embedding added, the cls token prepended. The first block's input."""
        b = patch_tokens.shape[0]
        patch_tokens = patch_tokens + self.resized_pos_embed(grid_hw).to(patch_tokens.dtype)
        cls_tok = (self.cls_token + self.cls_embed).to(patch_tokens.dtype).expand(b, 1, self.features)
        return torch.cat([cls_tok, patch_tokens], dim=1)

    def outnorm_taps(self, outputs):
        return tuple(layer_norm(o, self.outnorm.weight, self.outnorm.bias) for o in outputs)

    def forward(self, patch_tokens, grid_hw):
        """patch_tokens: (B, N, F). Returns the 4 tapped (B, 1+N, F) token
        tensors, each through the shared output norm."""
        tokens = self.embed(patch_tokens, grid_hw)
        outputs = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i in self.taps:
                outputs.append(tokens)
        return self.outnorm_taps(outputs)

    def forward_capture(self, patch_tokens, grid_hw):
        """``forward`` on the plain attention path, keeping what each block
        made: (the 4 tapped, out-normed stages, {"block_tokens": [(B, 1+N,
        F)] * L, "attention": [(B, H, N, N) float32] * L})."""
        tokens = self.embed(patch_tokens, grid_hw)
        internals = {"block_tokens": [], "attention": []}
        outputs = []
        for i, block in enumerate(self.blocks):
            tokens, weights = block.forward_capture(tokens)
            internals["block_tokens"].append(tokens)
            internals["attention"].append(weights)
            if i in self.taps:
                outputs.append(tokens)
        return self.outnorm_taps(outputs), internals
