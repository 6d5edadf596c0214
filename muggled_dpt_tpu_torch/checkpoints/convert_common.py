"""Shared tensor helpers for converting original torch state dicts into this
package's parameters.

The original checkpoints already use torch's own layouts (Linear (out, in),
Conv2d OIHW, ConvTranspose2d (in, out, kh, kw)), so conversion is a float32
cast plus the one reordering the attention kernel needs: the fused qkv
projection's output rows go head-major, [head][q|k|v][dim]."""

from __future__ import annotations

import torch


def t_tensor(w) -> torch.Tensor:
    """numpy array or tensor -> contiguous float32 CPU tensor (a copy)."""
    return torch.as_tensor(w, dtype=torch.float32, device="cpu").clone().contiguous()


def qkv_head_major(weight: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Reorder a fused qkv Linear weight's output rows from torch's
    [q|k|v][head][dim] to head-major [head][q|k|v][dim], so each head's q, k
    and v land contiguous in the projection output. The flash kernel then
    reads one (N, 3D) slab per head straight from the qkv matmul output."""
    c3, cin = weight.shape
    d = c3 // 3 // num_heads
    return weight.reshape(3, num_heads, d, cin).permute(1, 0, 2, 3).reshape(c3, cin).contiguous()


def qkv_vec_head_major(vec: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Same [q|k|v][head][dim] -> [head][q|k|v][dim] reorder for a bias vector."""
    c3 = vec.shape[-1]
    d = c3 // 3 // num_heads
    return vec.reshape(3, num_heads, d).permute(1, 0, 2).reshape(c3).contiguous()


def qkv_bias(q_bias: torch.Tensor, v_bias: torch.Tensor) -> torch.Tensor:
    """BEiT's and SwinV2's attention have q and v biases and no k bias: the
    fused qkv bias is q_bias | zeros | v_bias, in torch's [q|k|v][head][dim]
    order."""
    q_bias, v_bias = q_bias.reshape(-1), v_bias.reshape(-1)
    return torch.cat([q_bias, torch.zeros_like(q_bias), v_bias])


def max_index(state_dict: dict, prefix: str) -> int:
    """Largest integer appearing right after `prefix.` across keys.

    `prefix` must be a literal key prefix (no '#' digit wildcards): the suffix
    is sliced at len(prefix), which would misalign if '#' matched a
    different-length digit run."""
    from .key_regex import get_nth_integer, has_prefix

    if "#" in prefix:
        raise ValueError("max_index requires a literal prefix (no '#' wildcards)")
    best = -1
    for k in state_dict:
        if has_prefix(k, prefix + ".#."):
            best = max(best, get_nth_integer(k[len(prefix) :], 0))
    return best
