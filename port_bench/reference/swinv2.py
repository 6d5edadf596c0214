"""MiDaS v3.1 SwinV2 (``dpt_swin2_large_384``) in plain float32 PyTorch, from
the original checkpoint's keys (github.com/isl-org/MiDaS
``midas/backbones/swin2.py:_make_pretrained_swin2l24_384``,
``midas/backbones/swin_common.py``, ``midas/dpt_depth.py``,
``midas/blocks.py``; timm's ``swin_transformer_v2.py``, the backbone
``swinv2_large_window12to24_192to384_22kft1k``).

The forward: a 4-pixel patch embed and its LayerNorm (eps 1e-5); four
stages of post-norm blocks, x + LN1(attention(x)) then x + LN2(MLP(x)),
with a 2x2 patch merge (top-left, bottom-left, top-right, bottom-right
concatenated, a 4C -> 2C linear with no bias, then LayerNorm) between them.
Each block attends within windows; odd blocks roll the grid by half a window
first and mask (-100) pairs of tokens from different rolled regions. The
attention is scaled cosine: l2-normalized q and k, times
exp(min(logit_scale, log 100)) per head, plus the continuous position bias,
16 sigmoid of an MLP (2 -> 512, ReLU, 512 -> H with no bias) over the
log-spaced relative coordinates, gathered per (query, key) pair. q and v
have biases, k has none. The neck reads the last block of each stage (hooks
[1, 1, 17, 1] at 2/2/18/2), each as a map at its stage's grid with no
readout, projection or resample ("fuse-only": ``scratch.layer<i>_rn``, a
3x3 convolution with no bias), then the fusion blocks and the head, whose
upsample is a fixed 2x.

The CPB table, its index and the shift mask are worked out here from the
grid, the window and the stored CPB MLP, as timm builds its buffers.

Departures from the published model, none of which changes the forward at
384x384:
* The window plan. timm fixes each stage's window at construction for one
  input size: where the stage's grid is at most the window it takes the
  whole grid as one window and does not shift, otherwise the window must
  divide the grid. Here, so that other input sizes run, a window that does
  not divide a larger grid becomes the grid's divisor in [window/2,
  2 window) nearest the grid. At 384 (grids 96, 48, 24, 12 with window 24)
  the two agree: 24 and 24 shifting, then 24 and 12 as one window each.
* The shift mask's regions are given by their bounds rather than timm's
  slices, which agree with them wherever both axes shift (every square
  grid).
* The attention logits are computed over chunks of (frame, window) pairs,
  each chunk's float32 logits under ``ATTENTION_CHUNK_BYTES``.
* The backbone's final LayerNorm is not applied: nothing the neck reads
  comes after it."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import ATTENTION_CHUNK_BYTES, conv2d, exact, fusion, head, linear, preprocess, weight

MEAN_RGB = (0.5, 0.5, 0.5)
STD_RGB = (0.5, 0.5, 0.5)
LN_EPS = 1e-5
MASK_VALUE = -100.0
LOGIT_SCALE_MAX = math.log(1.0 / 0.01)


def window_and_shift(grid: int, window: int) -> tuple:
    """(window, shift) along one axis of a stage's grid."""
    if grid <= window:
        return grid, 0
    if grid % window:
        window = min((d for d in range(window // 2, 2 * window) if grid % d == 0), key=lambda d: abs(grid - d))
        if grid <= window:
            return window, 0
    return window, window // 2


def to_windows(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, wh * ww, C), windows in row-major order, frame-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, c)


def from_windows(x: torch.Tensor, wh: int, ww: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``to_windows``."""
    c = x.shape[-1]
    x = x.reshape(-1, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def shift_mask(h: int, w: int, wh: int, ww: int, sh: int, sw: int, device) -> torch.Tensor:
    """(nW, A, A): 0 between tokens of one region of the rolled grid, -100
    between regions; the regions are [0, H - wh), [H - wh, H - sh),
    [H - sh, H) along each axis."""
    def band(size, win, shift):
        i = torch.arange(size, device=device)
        return (i >= size - win).long() + (i >= size - shift).long()

    region = (band(h, wh, sh)[:, None] * 3 + band(w, ww, sw)[None, :]).float()
    windows = to_windows(region[None, :, :, None], wh, ww)[..., 0]  # (nW, A)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def relative_coords_table(wh: int, ww: int, pretrained, device) -> torch.Tensor:
    """((2wh-1) (2ww-1), 2) float32: the relative offsets over the
    pretrained window minus 1 (the window's own where there is none), times
    8, then sign(t) log2(|t| + 1) / log2(8)."""
    rh = torch.arange(-(wh - 1), wh, dtype=torch.float32, device=device)
    rw = torch.arange(-(ww - 1), ww, dtype=torch.float32, device=device)
    table = torch.stack(torch.meshgrid(rh, rw, indexing="ij"), dim=-1)
    ph, pw = (pretrained, pretrained) if pretrained else (wh, ww)
    table = table / torch.tensor([ph - 1, pw - 1], dtype=torch.float32, device=device) * 8
    table = torch.sign(table) * torch.log2(table.abs() + 1.0) / math.log2(8)
    return table.reshape(-1, 2)


def relative_position_index(wh: int, ww: int, device) -> torch.Tensor:
    """(A, A) int64: the table row of each (query, key) pair's offset."""
    coords = torch.stack(torch.meshgrid(torch.arange(wh, device=device), torch.arange(ww, device=device),
                                        indexing="ij")).flatten(1)  # (2, A)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    return (rel[..., 0] + wh - 1) * (2 * ww - 1) + rel[..., 1] + ww - 1


def position_bias(sd: dict, pre: str, table, index, heads: int, q=exact) -> torch.Tensor:
    """(H, A, A): 16 sigmoid(cpb_mlp(table))[index]."""
    w0, b0 = weight(sd, f"{pre}.attn.cpb_mlp.0.weight"), weight(sd, f"{pre}.attn.cpb_mlp.0.bias")
    hidden = torch.relu(linear(table, w0, b0, q))
    lut = linear(hidden, weight(sd, f"{pre}.attn.cpb_mlp.2.weight"), None, q)  # (R, H)
    a = index.shape[0]
    return 16.0 * torch.sigmoid(lut[index.reshape(-1)].reshape(a, a, heads).permute(2, 0, 1))


def window_attention(x, sd: dict, pre: str, heads: int, bias, mask, q=exact) -> torch.Tensor:
    """(B * nW, A, C) windows -> (B * nW, A, C): scaled cosine attention
    with the position bias (H, A, A) and the mask (nW, A, A) or None, then
    proj. The logits are taken a chunk of windows at a time."""
    n, a, c = x.shape
    d = c // heads
    q_bias, v_bias = weight(sd, f"{pre}.attn.q_bias"), weight(sd, f"{pre}.attn.v_bias")
    qkv_bias = torch.cat([q_bias, torch.zeros_like(q_bias), v_bias])
    qkv = linear(x, weight(sd, f"{pre}.attn.qkv.weight"), qkv_bias, q).reshape(n, a, 3, heads, d).permute(2, 0, 3, 1, 4)
    qn, kn, v = F.normalize(qkv[0], dim=-1), F.normalize(qkv[1], dim=-1), qkv[2]  # (n, H, A, D)
    scale = torch.clamp(weight(sd, f"{pre}.attn.logit_scale"), max=LOGIT_SCALE_MAX).exp()  # (H, 1, 1)
    out = torch.empty(n, heads, a, d, dtype=x.dtype, device=x.device)
    group = max(1, ATTENTION_CHUNK_BYTES // (4 * heads * a * a))
    for i0 in range(0, n, group):
        i1 = min(n, i0 + group)
        logits = (q(qn[i0:i1]) @ q(kn[i0:i1]).transpose(-1, -2)) * scale + bias
        if mask is not None:
            logits += mask[torch.arange(i0, i1, device=x.device) % mask.shape[0]][:, None]
        out[i0:i1] = q(torch.softmax(logits, dim=-1)) @ q(v[i0:i1])
        del logits
    out = out.transpose(1, 2).reshape(n, a, c)
    return linear(out, weight(sd, f"{pre}.attn.proj.weight"), weight(sd, f"{pre}.attn.proj.bias"), q)


def layer_norm(x, sd: dict, pre: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), weight(sd, f"{pre}.weight"), weight(sd, f"{pre}.bias"), LN_EPS)


def block(x, sd: dict, pre: str, heads: int, plan: tuple, bias, mask, q=exact) -> torch.Tensor:
    """One post-norm block on (B, H, W, C) tokens; ``plan`` (wh, ww, sh, sw),
    the shift (0, 0) on a block that does not shift."""
    _, h, w, _ = x.shape
    wh, ww, sh, sw = plan
    shifted = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2)) if sh or sw else x
    att = window_attention(to_windows(shifted, wh, ww), sd, pre, heads, bias, mask, q)
    att = from_windows(att, wh, ww, h, w)
    if sh or sw:
        att = torch.roll(att, shifts=(sh, sw), dims=(1, 2))
    x = x + layer_norm(att, sd, f"{pre}.norm1")
    hidden = F.gelu(linear(x, weight(sd, f"{pre}.mlp.fc1.weight"), weight(sd, f"{pre}.mlp.fc1.bias"), q))
    hidden = linear(hidden, weight(sd, f"{pre}.mlp.fc2.weight"), weight(sd, f"{pre}.mlp.fc2.bias"), q)
    return x + layer_norm(hidden, sd, f"{pre}.norm2")


def patch_merge(x, sd: dict, pre: str, q=exact) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 2C)."""
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    return layer_norm(linear(x, weight(sd, f"{pre}.reduction.weight"), None, q), sd, f"{pre}.norm")


@torch.no_grad()
def forward(sd: dict, config: dict, frames_u8: torch.Tensor, scaled_hw, q=exact) -> torch.Tensor:
    """(B, H, W, 3) RGB uint8 frames -> (B, h, w) float32 depth at ``scaled_hw``;
    ``q`` rounds every product's operands (``exact``: none)."""
    p = config["patch_size_px"]
    window_h, window_w = config["window_size_hw"]
    heads = config["heads_per_stage"]
    pretrained = config.get("pretrained_window_sizes_per_stage") or [None] * 4
    x = preprocess(frames_u8, scaled_hw, MEAN_RGB, STD_RGB)
    x = conv2d(x, weight(sd, "pretrained.model.patch_embed.proj.weight"),
               weight(sd, "pretrained.model.patch_embed.proj.bias"), q, stride=p)
    x = layer_norm(x.permute(0, 2, 3, 1), sd, "pretrained.model.patch_embed.norm")  # (B, gh, gw, C)
    maps = []
    for s, layers in enumerate(config["layers_per_stage"]):
        if s:
            x = patch_merge(x, sd, f"pretrained.model.layers.{s - 1}.downsample", q)
        _, h, w, _ = x.shape
        (wh, sh), (ww, sw) = window_and_shift(h, window_h), window_and_shift(w, window_w)
        table = relative_coords_table(wh, ww, pretrained[s], x.device)
        index = relative_position_index(wh, ww, x.device)
        mask = shift_mask(h, w, wh, ww, sh, sw, x.device) if sh or sw else None
        for i in range(layers):
            pre = f"pretrained.model.layers.{s}.blocks.{i}"
            bias = position_bias(sd, pre, table, index, heads[s], q)
            shifts = i % 2 == 1 and mask is not None
            x = block(x, sd, pre, heads[s], (wh, ww, sh, sw) if shifts else (wh, ww, 0, 0), bias,
                      mask if shifts else None, q)
        maps.append(x.permute(0, 3, 1, 2))  # the stage's last block: the hook's tokens as a map
    layers_rn = [conv2d(m, weight(sd, f"scratch.layer{s}_rn.weight"), None, q, padding=1)
                 for s, m in enumerate(maps, start=1)]
    path = fusion(layers_rn, sd, "scratch.refinenet", q)
    out_hw = (2 * path.shape[-2], 2 * path.shape[-1])
    return head(path, sd, "scratch.output_conv.0", "scratch.output_conv.2", "scratch.output_conv.4", out_hw, q)
