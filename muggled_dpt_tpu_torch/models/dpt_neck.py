"""DPT neck: reassembly -> fusion -> monocular depth head, on NCHW feature
maps.

The counterpart of ``muggled_dpt_tpu/models/dpt_neck.py`` with three readout
modes: 'ignore' (Depth-Anything: the cls token is dropped), 'project'
(BEiT: the cls token is concatenated onto every patch token, then Linear
2F -> F and exact GELU) and 'none' (SwinV2: no cls token and no resampling,
``FuseOnlyStage``). The ViT reassembly keeps the dense transposed-conv + 3x3
conv pair; fusion and head upsample with bilinear align_corners=True; the
head's upsample factor is P/8 for Depth-Anything and 2 for MiDaS; a metric
head ends in a sigmoid instead of a ReLU.

The int8 tier (``ops/quant.py:quantize_neck``) swaps the readout and 1x1
projections for ``QuantLinear``s and the residual units' and head's 3x3
convolutions for shiftsum ``QuantConv3x3``s; the ``*_p`` calls run either."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import conv2d, conv_transpose_blocky, gelu
from ..ops.quant import QuantLinear, conv1x1_p, conv3x3_p, linear_p
from ..ops.resize import resize_2d, resize_output_size


def readout_project(tokens, layer):
    """Readout 'project': [patch token, cls] -> Linear(2F -> F) -> exact GELU.
    tokens (B, 1+N, F) -> (B, N, F)."""
    patch = tokens[:, 1:, :]
    cls_tok = tokens[:, :1, :].expand_as(patch)
    return gelu(linear_p(torch.cat([patch, cls_tok], dim=-1), layer))


class ReassembleStage(nn.Module):
    """Tokens -> readout ('ignore' or 'project') -> projection (1x1 conv) ->
    resample by ``scale`` -> 3x3 fuse conv (no bias)."""

    def __init__(self, features: int, channels: int, fusion_channels: int, scale, readout: str = "ignore", device=None):
        super().__init__()
        if readout not in ("ignore", "project"):
            raise ValueError(f"unsupported readout {readout!r}")
        self.scale = scale
        self.readout = nn.Linear(2 * features, features, device=device) if readout == "project" else None
        self.proj = nn.Conv2d(features, channels, 1, device=device)
        if scale in (2, 4):
            self.resample = nn.ConvTranspose2d(channels, channels, scale, stride=scale, device=device)
        elif scale == 0.5:
            self.resample = nn.Conv2d(channels, channels, 3, stride=2, padding=1, device=device)
        else:
            self.resample = None
        self.fuse = nn.Conv2d(channels, fusion_channels, 3, padding=1, bias=False, device=device)

    def forward(self, tokens, grid_hw):
        gh, gw = grid_hw
        if self.readout is None:
            tokens = tokens[:, 1:, :]
        else:
            tokens = readout_project(tokens, self.readout)
        b = tokens.shape[0]
        if isinstance(self.proj, QuantLinear):  # per token, before the tokens become a map
            x = self.proj(tokens).transpose(1, 2).reshape(b, -1, gh, gw)
        else:
            x = conv2d(tokens.transpose(1, 2).reshape(b, -1, gh, gw), self.proj.weight, self.proj.bias)
        if self.scale in (2, 4):
            x = conv_transpose_blocky(x, self.resample.weight, self.resample.bias)
        elif self.scale == 0.5:
            x = conv2d(x, self.resample.weight, self.resample.bias, stride=2, padding=1)
        return conv2d(x, self.fuse.weight, None, padding=1)


class FuseOnlyStage(nn.Module):
    """The reassembly of a hierarchical encoder (SwinV2: readout 'none'): its
    stage maps already have the 4 scales, so there is no readout, projection
    or resample; only the 3x3 fuse conv (no bias) on the NCHW map."""

    def __init__(self, channels: int, fusion_channels: int, device=None):
        super().__init__()
        self.fuse = nn.Conv2d(channels, fusion_channels, 3, padding=1, bias=False, device=device)

    def forward(self, x_nchw):
        return conv2d(x_nchw, self.fuse.weight, None, padding=1)


class ResidualConvUnit(nn.Module):
    """ReLU -> 3x3 conv -> ReLU -> 3x3 conv, plus the skip."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x):
        h = conv3x3_p(torch.relu(x), self.conv1)
        h = conv3x3_p(torch.relu(h), self.conv2)
        return h + x


class FusionBlock(nn.Module):
    """RefineNet-style block: [res1(reassembly map) + previous] -> res2 ->
    2x bilinear (align_corners=True) -> 1x1 conv. The top-most block has no
    res1 (it has no previous map to add)."""

    def __init__(self, channels: int, top: bool, device=None):
        super().__init__()
        self.res1 = None if top else ResidualConvUnit(channels, device=device)
        self.res2 = ResidualConvUnit(channels, device=device)
        self.out = nn.Conv2d(channels, channels, 1, device=device)

    def forward(self, fmap, prev=None):
        x = fmap if prev is None else self.res1(fmap) + prev
        x = self.res2(x)
        x = resize_2d(x, resize_output_size(x.shape[-2:], 2.0), align_corners=True)
        return conv1x1_p(x, self.out)


def fusion_forward(reassembly_maps, blocks):
    """Top-down fusion of the 4 reassembly maps; returns a map at 8x the patch grid."""
    upx4, upx2, noscale, downx2 = reassembly_maps
    x = blocks[3](downx2)
    for fmap, block in ((noscale, blocks[2]), (upx2, blocks[1]), (upx4, blocks[0])):
        x = block(fmap, x)
    return x


class Head(nn.Module):
    """3x3 conv C -> C/2 -> upsample by P/8 -> 3x3 conv -> 32 -> ReLU ->
    1x1 conv -> 1 -> ReLU (sigmoid for metric). Returns (B, H, W)."""

    def __init__(self, channels: int, upsample_factor: float, is_metric: bool, device=None):
        super().__init__()
        self.upsample_factor = upsample_factor
        self.is_metric = is_metric
        self.conv_in = nn.Conv2d(channels, channels // 2, 3, padding=1, device=device)
        self.conv_mid = nn.Conv2d(channels // 2, 32, 3, padding=1, device=device)
        self.proj = nn.Conv2d(32, 1, 1, device=device)

    def tail(self, x):
        """The tail at full output resolution: 3x3 conv -> 32, ReLU, 1x1 conv
        -> 1, ReLU or sigmoid; (B, C/2, H, W) -> (B, H, W). What
        ``ops/kernels/head_tail.py`` computes in one kernel."""
        x = torch.relu(conv3x3_p(x, self.conv_mid))
        x = conv2d(x, self.proj.weight, self.proj.bias)
        x = torch.sigmoid(x) if self.is_metric else torch.relu(x)
        return x[:, 0]

    def forward(self, x):
        x = conv3x3_p(x, self.conv_in)
        x = resize_2d(x, resize_output_size(x.shape[-2:], self.upsample_factor), align_corners=True)
        return self.tail(x)
