"""Video Depth Anything's temporal motion module (AnimateDiff's, as
github.com/DepthAnything/Video-Depth-Anything
``video_depth_anything/motion_module/motion_module.py`` and ``attention.py``
have it): attention over the frames of a clip at each position of a map.

``TemporalModule(C)`` takes an NCHW map X of B*T frames, frame-major (the T
frames of a clip consecutive):

1. r = X; Y = GroupNorm(32 groups, eps 1e-6)(X) as (B*T, h*w, C) tokens;
   Y = proj_in(Y).
2. For each attention block: Z = LayerNorm(Y) (eps 1e-5), rearranged to
   (B*h*w, T, C) with the sinusoidal encoding of the frame index added
   (``pe``; into the attention's input only); q, k, v from one bias-free
   product (``to_q``, ``to_k``, ``to_v`` side by side); softmax(q k^T /
   sqrt(C/heads)) v per head over the T frames at each position;
   ``to_out``; rearranged back and added to Y.
3. Y = Y + ff_out(a * GELU(g)), [a | g] = ff_in(LayerNorm(Y)) (GEGLU, exact
   GELU on the second half).
4. proj_out(Y) back to (B*T, C, h, w), plus r.

The attention core runs through ``F.scaled_dot_product_attention`` on every
path: no kernel of the port computes it. Spans (``utils/observability.py``):
``temporal`` around each module call, ``temporal.attention`` around each
attention core."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import gelu, layer_norm, linear
from ..utils.observability import trace_span

GROUPS = 32
GROUP_NORM_EPS = 1e-6
LAYER_NORM_EPS = 1e-5  # nn.LayerNorm's default, which the original's norms keep
FF_MULT = 4  # the GEGLU feed-forward's hidden width over C (FeedForward's default mult)


def sinusoidal_encoding(max_frames: int, channels: int) -> torch.Tensor:
    """(max_frames, C) float32: sin(t w_i) at channel 2i, cos(t w_i) at 2i + 1,
    w_i = 10000^(-2i / C): the original's ``PositionalEncoding.pe``."""
    t = torch.arange(max_frames, dtype=torch.float32)[:, None]
    w = torch.exp(torch.arange(0, channels, 2, dtype=torch.float32) * (-math.log(10000.0) / channels))
    pe = torch.zeros(max_frames, channels)
    pe[:, 0::2] = torch.sin(t * w)
    pe[:, 1::2] = torch.cos(t * w)
    return pe


class TemporalAttention(nn.Module):
    """One attention block of a temporal module: Y + to_out(attention over
    the frames of LayerNorm(Y) + pe)."""

    def __init__(self, channels: int, heads: int, max_frames: int, device=None):
        super().__init__()
        self.heads = heads
        self.norm = nn.LayerNorm(channels, eps=LAYER_NORM_EPS, device=device)
        self.qkv = nn.Linear(channels, 3 * channels, bias=False, device=device)  # rows [q|k|v]
        self.out = nn.Linear(channels, channels, device=device)
        self.register_buffer("pe", torch.empty(max_frames, channels, device=device))

    def forward(self, y, frames: int):
        """(B*T, P, C) frame-major tokens -> the same with the block's residual added."""
        bt, p, c = y.shape
        b = bt // frames
        z = layer_norm(y, self.norm.weight, self.norm.bias, LAYER_NORM_EPS)
        z = z.reshape(b, frames, p, c).transpose(1, 2).reshape(b * p, frames, c) + self.pe[:frames]
        qkv = linear(z, self.qkv.weight).reshape(b * p, frames, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        with trace_span("temporal.attention"):
            a = F.scaled_dot_product_attention(q, k, v)  # (B*P, heads, T, C/heads)
        a = linear(a.transpose(1, 2).reshape(b * p, frames, c), self.out.weight, self.out.bias)
        return y + a.reshape(b, p, frames, c).transpose(1, 2).reshape(bt, p, c)


class TemporalModule(nn.Module):
    """GroupNorm, proj_in, ``attention_blocks`` temporal attention blocks, a
    GEGLU feed-forward of ``FF_MULT`` * C, proj_out, and the map's residual."""

    def __init__(self, channels: int, heads: int, attention_blocks: int, max_frames: int, device=None):
        super().__init__()
        self.norm = nn.GroupNorm(GROUPS, channels, eps=GROUP_NORM_EPS, device=device)
        self.proj_in = nn.Linear(channels, channels, device=device)
        self.attention = nn.ModuleList(TemporalAttention(channels, heads, max_frames, device=device)
                                       for _ in range(attention_blocks))
        self.ff_norm = nn.LayerNorm(channels, eps=LAYER_NORM_EPS, device=device)
        self.ff_in = nn.Linear(channels, 2 * FF_MULT * channels, device=device)
        self.ff_out = nn.Linear(FF_MULT * channels, channels, device=device)
        self.proj_out = nn.Linear(channels, channels, device=device)

    def forward(self, x, frames: int):
        """(B*T, C, h, w) map of clips of ``frames`` frames -> the same shape."""
        with trace_span("temporal"):
            bt, c, h, w = x.shape
            y = F.group_norm(x, GROUPS, self.norm.weight, self.norm.bias, GROUP_NORM_EPS)
            y = linear(y.permute(0, 2, 3, 1).reshape(bt, h * w, c), self.proj_in.weight, self.proj_in.bias)
            for block in self.attention:
                y = block(y, frames)
            h_ff = layer_norm(y, self.ff_norm.weight, self.ff_norm.bias, LAYER_NORM_EPS)
            a, g = linear(h_ff, self.ff_in.weight, self.ff_in.bias).chunk(2, dim=-1)
            y = y + linear(a * gelu(g), self.ff_out.weight, self.ff_out.bias)
            y = linear(y, self.proj_out.weight, self.proj_out.bias)
            return y.reshape(bt, h, w, c).permute(0, 3, 1, 2) + x
