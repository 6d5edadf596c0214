"""Video Depth Anything in plain float32 PyTorch, from the original
checkpoint's keys (github.com/DepthAnything/Video-Depth-Anything
``video_depth_anything/video_depth.py`` ``VideoDepthAnything``,
``dpt_temporal.py`` ``DPTHeadTemporal``, ``motion_module/motion_module.py``
``TemporalModule`` and ``attention.py``, from AnimateDiff's motion module).

The B frames given are one clip in time order. The preprocessing, the
DINOv2 blocks and the DPT pieces are the Depth-Anything V2 reference's, by
import; the encoder feeds the neck from the configuration's
``encoder_taps`` (the published ``intermediate_layer_idx``, [4, 11, 17, 23]
at ViT-L); the head's keys sit under ``head.``. The four temporal modules
are written out here: ``motion_modules.0`` and ``.1`` on the third and fourth
reassembly maps after their resample, before ``layer3_rn`` and
``layer4_rn``; ``.2`` on refinenet4's output, ``.3`` on refinenet3's. Each
module on an NCHW map X of T frames:

1. r = X; Y = GroupNorm(32 groups, eps 1e-6)(X) as (T, h*w, C) tokens; Y = proj_in(Y).
2. Per attention block j: Z = LayerNorm_j(Y) (eps 1e-5), rearranged to
   (h*w, T, C), plus ``pe[:T]`` (the sinusoidal ``PositionalEncoding``
   buffer, computed where the weights lack it); q, k, v = to_q, to_k, to_v
   (no bias); softmax(q k^T / sqrt(C/8)) v over the T frames, 8 heads;
   to_out.0; rearranged back; Y = Y + that.
3. Y = Y + ff.net.2(a * GELU(g)), [a | g] = ff.net.0.proj(LayerNorm_ff(Y)) (GEGLU, exact GELU).
4. proj_out(Y) back to (T, C, h, w), plus r.

Departures, none of which changes the arithmetic the comparison sees:

- the learned position embedding is resized to the patch grid by size
  (bicubic, align_corners=False, no antialias), where DINOv2's
  ``interpolate_pos_encoding`` passes a scale factor with a 0.1 offset: a
  departure shared with the system under test, as the DA-V2 reference notes;
- ``DPTHeadTemporal`` upsamples output_conv1's map to 14 times the patch
  grid and ``VideoDepthAnything.forward`` then resizes the depth to the input
  size (align_corners=True) and applies ReLU again: at a size that is a
  multiple of the patch, as here, that resize is the identity and the ReLU
  repeats output_conv2's, so the DA-V2 head stands for both;
- the original runs the last two fusion blocks and the head in micro-batches
  of 4 frames, and the temporal attention here in chunks of positions: every
  frame and every position is computed on its own, so neither changes a value."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import (ATTENTION_CHUNK_BYTES, conv2d, exact, head, linear, preprocess, resample, residual_unit, tokens_to_map,
               vit_block, weight)
from .depth_anything_v2 import MEAN_RGB, RESAMPLE, STD_RGB, position_embedding

GROUPS = 32
HEADS = 8  # num_attention_heads of the released motion modules


def sinusoidal_pe(frames: int, channels: int, device) -> torch.Tensor:
    """(frames, C): sin(t / 10000^(2i/C)) at channel 2i, cos at 2i + 1."""
    t = torch.arange(frames, dtype=torch.float32, device=device)[:, None]
    w = torch.exp(torch.arange(0, channels, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / channels))
    pe = torch.zeros(frames, channels, device=device)
    pe[:, 0::2] = torch.sin(t * w)
    pe[:, 1::2] = torch.cos(t * w)
    return pe


def chunk_positions(frames: int) -> int:
    """Positions whose float32 logits (heads x T x T each) fit ``ATTENTION_CHUNK_BYTES``."""
    return max(1, ATTENTION_CHUNK_BYTES // (4 * HEADS * frames * frames))


def temporal_attention(z, wq, wk, wv, q=exact, chunk: int | None = None) -> torch.Tensor:
    """(P, T, C) position-major tokens -> (P, T, C): per position and head,
    softmax(q k^T / sqrt(D)) v over the T frames, ``chunk`` positions at a
    time (None: as many as ``chunk_positions`` allows)."""
    p, t, c = z.shape
    d = c // HEADS

    def split(x):
        return x.reshape(p, t, HEADS, d).transpose(1, 2)  # (P, heads, T, D)

    qs = split(linear(z, wq, None, q)) * d**-0.5
    k, v = split(linear(z, wk, None, q)), split(linear(z, wv, None, q))
    out = torch.empty(p, HEADS, t, d, dtype=z.dtype, device=z.device)
    step = chunk or chunk_positions(t)
    for s in range(0, p, step):
        rows = slice(s, s + step)
        logits = q(qs[rows]) @ q(k[rows]).transpose(-1, -2)
        out[rows] = q(torch.softmax(logits, dim=-1)) @ q(v[rows])
    return out.transpose(1, 2).reshape(p, t, c)


def temporal_module(x: torch.Tensor, sd: dict, pre: str, frames: int, q=exact, chunk: int | None = None
                    ) -> torch.Tensor:
    """``TemporalModule`` at ``pre`` (``head.motion_modules.<i>``) on an NCHW
    map of clips of ``frames`` frames, frame-major."""
    bt, c, h, w = x.shape
    b, n = bt // frames, h * w
    tt = f"{pre}.temporal_transformer"
    blk = f"{tt}.transformer_blocks.0"
    y = F.group_norm(x, GROUPS, weight(sd, f"{tt}.norm.weight"), weight(sd, f"{tt}.norm.bias"), 1e-6)
    y = linear(y.permute(0, 2, 3, 1).reshape(bt, n, c), weight(sd, f"{tt}.proj_in.weight"),
               weight(sd, f"{tt}.proj_in.bias"), q)
    j = 0
    while f"{blk}.attention_blocks.{j}.to_q.weight" in sd:
        att = f"{blk}.attention_blocks.{j}"
        z = F.layer_norm(y, (c,), weight(sd, f"{blk}.norms.{j}.weight"), weight(sd, f"{blk}.norms.{j}.bias"), 1e-5)
        pe = sd.get(f"{att}.pos_encoder.pe")
        pe = sinusoidal_pe(frames, c, x.device) if pe is None else pe.float().reshape(-1, c)[:frames]
        z = z.reshape(b, frames, n, c).transpose(1, 2).reshape(b * n, frames, c) + pe
        a = temporal_attention(z, weight(sd, f"{att}.to_q.weight"), weight(sd, f"{att}.to_k.weight"),
                               weight(sd, f"{att}.to_v.weight"), q, chunk)
        a = linear(a, weight(sd, f"{att}.to_out.0.weight"), weight(sd, f"{att}.to_out.0.bias"), q)
        y = y + a.reshape(b, n, frames, c).transpose(1, 2).reshape(bt, n, c)
        j += 1
    z = F.layer_norm(y, (c,), weight(sd, f"{blk}.ff_norm.weight"), weight(sd, f"{blk}.ff_norm.bias"), 1e-5)
    a, g = linear(z, weight(sd, f"{blk}.ff.net.0.proj.weight"), weight(sd, f"{blk}.ff.net.0.proj.bias"),
                  q).chunk(2, -1)
    y = y + linear(a * F.gelu(g), weight(sd, f"{blk}.ff.net.2.weight"), weight(sd, f"{blk}.ff.net.2.bias"), q)
    y = linear(y, weight(sd, f"{tt}.proj_out.weight"), weight(sd, f"{tt}.proj_out.bias"), q)
    return y.reshape(bt, h, w, c).permute(0, 3, 1, 2) + x


def fusion_block(layer_rn: torch.Tensor, path, sd: dict, pre: str, q=exact) -> torch.Tensor:
    """One FeatureFusionBlock: [path + resConfUnit1(layer)] (refinenet4: the
    layer alone), resConfUnit2, x2 bilinear (align_corners=True), out_conv."""
    x = layer_rn if path is None else path + residual_unit(layer_rn, sd, f"{pre}.resConfUnit1", q)
    x = residual_unit(x, sd, f"{pre}.resConfUnit2", q)
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    return conv2d(x, weight(sd, f"{pre}.out_conv.weight"), weight(sd, f"{pre}.out_conv.bias"), q)


@torch.no_grad()
def forward(sd: dict, config: dict, frames_u8: torch.Tensor, scaled_hw, q=exact, chunk: int | None = None
            ) -> torch.Tensor:
    """(T, H, W, 3) RGB uint8 frames of one clip -> (T, h, w) float32 depth at
    ``scaled_hw``; ``q`` rounds every product's operands (``exact``: none);
    ``chunk``: positions per temporal attention step (None: by memory)."""
    heads = config["num_heads"]
    p = config["patch_size_px"]
    frames = frames_u8.shape[0]
    x = preprocess(frames_u8, scaled_hw, MEAN_RGB, STD_RGB)
    x = conv2d(x, weight(sd, "pretrained.patch_embed.proj.weight"), weight(sd, "pretrained.patch_embed.proj.bias"), q,
               stride=p)
    _, _, gh, gw = x.shape
    x = torch.cat([weight(sd, "pretrained.cls_token").expand(frames, 1, -1), x.flatten(2).transpose(1, 2)], dim=1)
    x = x + position_embedding(sd, (gh, gw))
    outputs = []
    for i in range(config["num_blocks"]):
        pre = f"pretrained.blocks.{i}"
        x = vit_block(x, sd, pre, heads, ("ls1.gamma", "ls2.gamma"), weight(sd, f"{pre}.attn.qkv.bias"), q=q)
        if i in config["encoder_taps"]:
            outputs.append(F.layer_norm(x, (x.shape[-1],), weight(sd, "pretrained.norm.weight"),
                                        weight(sd, "pretrained.norm.bias"), 1e-6))
    layers = []
    for i, (t, scale) in enumerate(zip(outputs, RESAMPLE)):
        m = tokens_to_map(t[:, 1:], (gh, gw))  # use_clstoken False: the cls token is dropped
        m = conv2d(m, weight(sd, f"head.projects.{i}.weight"), weight(sd, f"head.projects.{i}.bias"), q)
        if scale != 1:
            m = resample(m, weight(sd, f"head.resize_layers.{i}.weight"), weight(sd, f"head.resize_layers.{i}.bias"),
                         scale, q)
        layers.append(m)
    layers[2] = temporal_module(layers[2], sd, "head.motion_modules.0", frames, q, chunk)
    layers[3] = temporal_module(layers[3], sd, "head.motion_modules.1", frames, q, chunk)
    rn = [conv2d(m, weight(sd, f"head.scratch.layer{i + 1}_rn.weight"), None, q, padding=1)
          for i, m in enumerate(layers)]
    path = fusion_block(rn[3], None, sd, "head.scratch.refinenet4", q)
    path = temporal_module(path, sd, "head.motion_modules.2", frames, q, chunk)
    path = fusion_block(rn[2], path, sd, "head.scratch.refinenet3", q)
    path = temporal_module(path, sd, "head.motion_modules.3", frames, q, chunk)
    path = fusion_block(rn[1], path, sd, "head.scratch.refinenet2", q)
    path = fusion_block(rn[0], path, sd, "head.scratch.refinenet1", q)
    return head(path, sd, "head.scratch.output_conv1", "head.scratch.output_conv2.0", "head.scratch.output_conv2.2",
                scaled_hw, q)
