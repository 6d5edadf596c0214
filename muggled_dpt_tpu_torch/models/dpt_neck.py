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

The upsample (``upsample``) follows what its input shows: with ``use_kernel``
on (the family's ``enable_optimizations``), a CUDA map goes through the
hand-written kernel (``ops/kernels/upsample.py``), an exported program holds
the operator ``mdpt::upsample_bilinear_ac``; with it off (the train step's
``plain_attention``), or on the CPU, ``F.interpolate`` (``resize_2d``) runs,
with the same result.

The int8 tier (``ops/quant.py:quantize_neck``) swaps the readout and 1x1
projections for ``QuantLinear``s and the residual units' and head's 3x3
convolutions for shiftsum ``QuantConv3x3``s; the ``*_p`` calls run either."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import library  # noqa: F401  (registers torch.ops.mdpt.*)
from ..ops.kernels.upsample import upsample_bilinear_ac
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
    resample by ``scale`` -> 3x3 fuse conv (no bias). ``fuse=False`` leaves
    the fuse conv to the fusion block that takes the map (``FusionBlock``'s
    ``fuse_channels``): Video Depth Anything runs a temporal module between
    the resample and that conv."""

    def __init__(self, features: int, channels: int, fusion_channels: int, scale, readout: str = "ignore",
                 fuse: bool = True, device=None):
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
        self.fuse = nn.Conv2d(channels, fusion_channels, 3, padding=1, bias=False, device=device) if fuse else None

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
        return x if self.fuse is None else conv2d(x, self.fuse.weight, None, padding=1)


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


def upsample(x, out_hw, use_kernel: bool):
    """Bilinear align_corners=True resize of an NCHW map to ``out_hw``: the
    kernel for a CUDA map with ``use_kernel``, its operator node while
    ``torch.export`` traces, else ``F.interpolate``."""
    if use_kernel and torch.compiler.is_exporting():
        return torch.ops.mdpt.upsample_bilinear_ac(x, list(out_hw))
    if use_kernel and x.is_cuda:
        return upsample_bilinear_ac(x, out_hw)
    return resize_2d(x, out_hw, align_corners=True)


class FusionBlock(nn.Module):
    """RefineNet-style block: [res1(reassembly map) + previous] -> res2 ->
    2x bilinear (align_corners=True) -> 1x1 conv. The top-most block has no
    res1 (it has no previous map to add). ``fuse_channels``: the block
    first runs its reassembly stage's 3x3 fuse conv (no bias) on the map,
    from that many channels (a stage built with ``fuse=False``)."""

    def __init__(self, channels: int, top: bool, use_kernel: bool = True, fuse_channels: int | None = None, device=None):
        super().__init__()
        self.use_kernel = use_kernel
        self.fuse = None
        if fuse_channels is not None:
            self.fuse = nn.Conv2d(fuse_channels, channels, 3, padding=1, bias=False, device=device)
        self.res1 = None if top else ResidualConvUnit(channels, device=device)
        self.res2 = ResidualConvUnit(channels, device=device)
        self.out = nn.Conv2d(channels, channels, 1, device=device)

    def forward(self, fmap, prev=None):
        if self.fuse is not None:
            fmap = conv2d(fmap, self.fuse.weight, None, padding=1)
        x = fmap if prev is None else self.res1(fmap) + prev
        x = self.res2(x)
        x = upsample(x, resize_output_size(x.shape[-2:], 2.0), self.use_kernel)
        return conv1x1_p(x, self.out)


def fusion_forward(reassembly_maps, blocks, input_scales=None):
    """Top-down fusion of the 4 reassembly maps; returns a map at 8x the patch grid.

    input_scales: optional (f1, f2, f3, f4), the fusion-scaling experiment's
    hook: the top block's input is multiplied by f4, and for blocks 2, 1
    and 0 the prior fusion map (not the reassembly map) by f3, f2 and f1
    before the residual add."""
    def scaled(x, f):
        return x if input_scales is None else x * f

    f1, f2, f3, f4 = (None,) * 4 if input_scales is None else input_scales
    upx4, upx2, noscale, downx2 = reassembly_maps
    x = blocks[3](scaled(downx2, f4))
    for fmap, block, f in ((noscale, blocks[2], f3), (upx2, blocks[1], f2), (upx4, blocks[0], f1)):
        x = block(fmap, scaled(x, f))
    return x


class Head(nn.Module):
    """3x3 conv C -> C/2 -> upsample by P/8 -> 3x3 conv -> 32 -> ReLU ->
    1x1 conv -> 1 -> ReLU (sigmoid for metric). Returns (B, H, W)."""

    def __init__(self, channels: int, upsample_factor: float, is_metric: bool, use_kernel: bool = True, device=None):
        super().__init__()
        self.use_kernel = use_kernel
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
        x = upsample(x, resize_output_size(x.shape[-2:], self.upsample_factor), self.use_kernel)
        return self.tail(x)
