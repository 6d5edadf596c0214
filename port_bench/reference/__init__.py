"""The plain float32 reference that decides ``correct``: one file per family
(``<family>.py``: ``forward(state_dict, config, frames, scaled_hw)``), and here
the parts both families share: the preprocessing, a ViT block, and the DPT
reassembly, fusion and head.

Every product (each linear, convolution and attention matmul) takes its
operands through ``q``, accumulating in float32: ``exact`` for the
reference; ``bf16`` for the yardstick of bfloat16's own rounding; ``fp8_e4m3``
for the control, the same reference in the precision below the
configuration's bfloat16.

Plain PyTorch operations in float32 with TF32 off, written from the original
models (github.com/DepthAnything/Depth-Anything-V2 ``depth_anything_v2/dpt.py``,
``dinov2.py``, ``util/blocks.py``; github.com/isl-org/MiDaS
``midas/backbones/beit.py``, ``midas/blocks.py``) and from the original
checkpoints' keys. It imports nothing of the port: it takes the original
weights and the frames, and works out itself what the port derives from them
(the position-embedding resize, the relative-position bias)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

ATTENTION_CHUNK_BYTES = 2 << 30  # float32 logits held at once: heads are taken in groups under this
FP8_E4M3_MAX = 448.0


def taps(num_blocks: int) -> tuple:
    """The blocks whose outputs feed the neck: the end of each quarter
    (MiDaS's BEiT-L hooks 5, 11, 17, 23; the port's Depth-Anything V2, whose
    published ViT-L taps differ: see ``depth_anything_v2.py``)."""
    per = num_blocks // 4
    return tuple(per * (i + 1) - 1 for i in range(4))


def exact(t: torch.Tensor) -> torch.Tensor:
    """The reference's own precision: operands as they are, float32."""
    return t


def bf16(t: torch.Tensor) -> torch.Tensor:
    """An operand rounded to bfloat16 and back: the yardstick of the rounding a
    bfloat16 model cannot avoid."""
    return t.to(torch.bfloat16).float()


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """An operand rounded to float8 e4m3 under one per-tensor scale (its
    largest magnitude to 448) and back: the control's precision."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in full float32 (no TF32) inside."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def weight(sd: dict, key: str) -> torch.Tensor:
    return sd[key].float()


def preprocess(frames_u8: torch.Tensor, scaled_hw, mean_rgb, std_rgb) -> torch.Tensor:
    """(B, H, W, 3) RGB uint8 -> (B, 3, h, w) float32: antialiased bilinear
    resize of the 0..255 values, then /255 and the family's normalization."""
    x = frames_u8.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=tuple(scaled_hw), mode="bilinear", align_corners=False, antialias=True)
    mean = torch.tensor(mean_rgb, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(std_rgb, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


def linear(x, w, b, q=exact):
    return F.linear(q(x), q(w), b)


def conv2d(x, w, b, q=exact, **kwargs):
    return F.conv2d(q(x), q(w), b, **kwargs)


def attention(x: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b, heads: int, bias=None, q=exact) -> torch.Tensor:
    """Multi-head self-attention with torch's [q|k|v][head][dim] qkv layout:
    softmax(q k^T / sqrt(D) + bias) v, heads taken a group at a time.
    ``bias``: None or (H, N, N)."""
    b, n, c = x.shape
    d = c // heads
    qkv = linear(x, qkv_w, qkv_b, q).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)  # (3, B, H, N, D)
    qs, k, v = qkv[0] * d**-0.5, qkv[1], qkv[2]
    out = torch.empty(b, heads, n, d, dtype=x.dtype, device=x.device)
    group = max(1, min(heads, ATTENTION_CHUNK_BYTES // (4 * n * n)))
    for i in range(b):
        for h0 in range(0, heads, group):
            h1 = min(heads, h0 + group)
            logits = q(qs[i, h0:h1]) @ q(k[i, h0:h1]).transpose(-1, -2)
            if bias is not None:
                logits += bias[h0:h1]
            out[i, h0:h1] = q(torch.softmax(logits, dim=-1)) @ q(v[i, h0:h1])
            del logits
    return linear(out.transpose(1, 2).reshape(b, n, c), proj_w, proj_b, q)


def vit_block(x, sd: dict, pre: str, heads: int, gamma_keys, qkv_bias, bias=None, q=exact, eps: float = 1e-6):
    """Pre-norm block with LayerScale: x + g1 * attn(LN1(x)); then + g2 * MLP(LN2(x)), exact GELU."""
    g1, g2 = (weight(sd, f"{pre}.{k}") for k in gamma_keys)
    h = F.layer_norm(x, (x.shape[-1],), weight(sd, f"{pre}.norm1.weight"), weight(sd, f"{pre}.norm1.bias"), eps)
    x = x + g1 * attention(h, weight(sd, f"{pre}.attn.qkv.weight"), qkv_bias, weight(sd, f"{pre}.attn.proj.weight"),
                           weight(sd, f"{pre}.attn.proj.bias"), heads, bias, q)
    h = F.layer_norm(x, (x.shape[-1],), weight(sd, f"{pre}.norm2.weight"), weight(sd, f"{pre}.norm2.bias"), eps)
    h = F.gelu(linear(h, weight(sd, f"{pre}.mlp.fc1.weight"), weight(sd, f"{pre}.mlp.fc1.bias"), q))
    return x + g2 * linear(h, weight(sd, f"{pre}.mlp.fc2.weight"), weight(sd, f"{pre}.mlp.fc2.bias"), q)


def tokens_to_map(tokens: torch.Tensor, grid_hw) -> torch.Tensor:
    """(B, gh*gw, C) patch tokens -> (B, C, gh, gw)."""
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, *grid_hw)


def resample(x: torch.Tensor, w, b, scale, q=exact) -> torch.Tensor:
    """The reassembly's resample: x4 / x2 transposed conv, identity, or a 3x3 stride-2 conv."""
    if scale in (4, 2):
        return F.conv_transpose2d(q(x), q(w), b, stride=scale)
    if scale == 0.5:
        return conv2d(x, w, b, q, stride=2, padding=1)
    return x


def residual_unit(x, sd: dict, pre: str, q=exact) -> torch.Tensor:
    """ResidualConvUnit: conv2(relu(conv1(relu(x)))) + x, 3x3 convs with bias."""
    h = conv2d(torch.relu(x), weight(sd, f"{pre}.conv1.weight"), weight(sd, f"{pre}.conv1.bias"), q, padding=1)
    h = conv2d(torch.relu(h), weight(sd, f"{pre}.conv2.weight"), weight(sd, f"{pre}.conv2.bias"), q, padding=1)
    return h + x


def fusion(layers_rn: list, sd: dict, refinenet: str, q=exact) -> torch.Tensor:
    """The four FeatureFusionBlocks, top down: refinenet4 on layer4, then
    refinenet3..1 each adding resConfUnit1(layer) to the path; each block's
    resConfUnit2, x2 bilinear upsample (align_corners=True; the originals
    give refinenet4..2 the next layer's size, which is twice theirs here),
    then its 1x1 out_conv."""
    path = None
    for k in (4, 3, 2, 1):
        pre = f"{refinenet}{k}"
        x = layers_rn[k - 1]
        if path is not None:
            if path.shape[-2:] != x.shape[-2:]:
                raise ValueError(f"fusion: path {tuple(path.shape)} does not meet layer {k} {tuple(x.shape)}")
            x = path + residual_unit(x, sd, f"{pre}.resConfUnit1", q)
        x = residual_unit(x, sd, f"{pre}.resConfUnit2", q)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        path = conv2d(x, weight(sd, f"{pre}.out_conv.weight"), weight(sd, f"{pre}.out_conv.bias"), q)
    return path


def head(path: torch.Tensor, sd: dict, conv_in: str, conv_mid: str, proj: str, out_hw, q=exact) -> torch.Tensor:
    """3x3 conv C -> C/2, bilinear (align_corners=True) to ``out_hw``, 3x3
    conv -> 32, ReLU, 1x1 conv -> 1, ReLU; (B, C, h, w) -> (B, H, W)."""
    x = conv2d(path, weight(sd, f"{conv_in}.weight"), weight(sd, f"{conv_in}.bias"), q, padding=1)
    x = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)
    x = torch.relu(conv2d(x, weight(sd, f"{conv_mid}.weight"), weight(sd, f"{conv_mid}.bias"), q, padding=1))
    return torch.relu(conv2d(x, weight(sd, f"{proj}.weight"), weight(sd, f"{proj}.bias"), q))[:, 0]
