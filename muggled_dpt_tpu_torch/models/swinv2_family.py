"""MiDaS v3.1 SwinV2: the whole forward pipeline, patch embed (4 px, then a
LayerNorm with eps 1e-5) -> SwinV2 encoder (4 stages at grids g, g/2, g/4,
g/8) -> fuse-only reassembly (readout 'none') -> fusion -> head (fixed 2x
upsample), and its family spec.

The counterpart of ``muggled_dpt_tpu/models/swinv2_family.py``."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import layer_norm, patchify_embed
from ..utils.observability import trace_span
from .dpt_neck import FuseOnlyStage, FusionBlock, Head, fusion_forward
from .swinv2 import SWIN_LN_EPS, SwinV2Encoder, aux_build_bytes, compute_cpb_stack

# MiDaS normalization
MEAN_RGB = (0.5, 0.5, 0.5)
STD_RGB = (0.5, 0.5, 0.5)
HEAD_UPSAMPLE = 2.0  # MiDaS's head upsamples by a fixed 2x


class SwinV2DPT(nn.Module):
    """Built from a config dict of ``checkpoints.swinv2.get_config_from_state_dict``.
    ``enable_optimizations`` (default True) sends the window attention
    through the window kernel's entry and the neck's upsample through its
    kernel; False runs the plain einsum path and ``F.interpolate``."""

    def __init__(self, config: dict, device=None):
        super().__init__()
        feats = config["features_per_stage"]
        p = config["patch_size_px"]
        cf = config["fusion_channels"]
        use_kernel = config.get("enable_optimizations", True)
        self.patch_embed = nn.Conv2d(3, feats[0], p, stride=p, device=device)
        self.patch_norm = nn.LayerNorm(feats[0], eps=SWIN_LN_EPS, device=device)
        self.encoder = SwinV2Encoder(config, use_kernel=use_kernel, device=device)
        self.reassemble = nn.ModuleList(FuseOnlyStage(f, cf, device=device) for f in feats)
        self.fusion = nn.ModuleList(FusionBlock(cf, top=(i == 3), use_kernel=use_kernel, device=device) for i in range(4))
        self.head = Head(cf, HEAD_UPSAMPLE, False, use_kernel=use_kernel, device=device)

    def forward(self, image_nchw, aux=None):
        """Normalized (B, 3, H, W) image, H and W multiples of 8 patches ->
        (B, H, W) depth. aux: the grid's cached ``compute_cpb_stack``, or
        None to build the CPB and masks inside the forward."""
        with trace_span("encoder"):
            stages = self.encoder(self.embed(image_nchw), aux)
        with trace_span("neck"):
            maps = [stage(t.permute(0, 3, 1, 2)) for stage, t in zip(self.reassemble, stages)]  # NCHW from here on
            return self.head(fusion_forward(maps, self.fusion))

    def embed(self, image_nchw):
        """Patch embed and its LayerNorm: the (B, gh, gw, C) tokens of the first block."""
        tokens, (gh, gw) = patchify_embed(image_nchw, self.patch_embed.weight, self.patch_embed.bias)
        tokens = layer_norm(tokens, self.patch_norm.weight, self.patch_norm.bias, eps=SWIN_LN_EPS)
        return tokens.reshape(tokens.shape[0], gh, gw, -1)

    def forward_capture(self, image_nchw, aux=None):
        """``forward`` on the plain attention path -> (depth, internals):
        the encoder's ``block_tokens`` ((B, gh*gw, C) per block) and
        ``attention`` ((B, nW, H, A, A) per block) plus ``reassembly_maps``
        (4 maps) and ``fused_map``, both NCHW (the JAX package's maps are
        NHWC)."""
        stages, internals = self.encoder.forward_capture(self.embed(image_nchw), aux)
        internals["reassembly_maps"] = [stage(t.permute(0, 3, 1, 2)) for stage, t in zip(self.reassemble, stages)]
        internals["fused_map"] = fusion_forward(internals["reassembly_maps"], self.fusion)
        return self.head(internals["fused_map"]), internals


def make_aux(net: SwinV2DPT, grid_hw, dtype):
    """The grid's CPB stacks and shift masks (``compute_cpb_stack``) in the model's dtype."""
    return compute_cpb_stack(net.encoder, grid_hw, dtype)


def aux_bytes_estimate(config: dict, grid_hw, dtype) -> int:
    """Peak device bytes of ``make_aux`` for a grid: what it keeps plus its
    build's transients."""
    return aux_build_bytes(config, grid_hw, torch.empty((), dtype=dtype).element_size())


def family_spec(config_dict: dict) -> dict:
    patch_px = config_dict["patch_size_px"]
    return {
        "mean_rgb": MEAN_RGB,
        "std_rgb": STD_RGB,
        "patch_size_px": patch_px,
        "tiling_size": 8 * patch_px,  # 3 patch merges halve the grid
        "default_size_px": config_dict["base_patch_grid_hw"][0] * patch_px,
        "make_aux": make_aux,
        "aux_bytes_estimate": aux_bytes_estimate,
        "forward_capture": SwinV2DPT.forward_capture,
        "head_upsample": HEAD_UPSAMPLE,
    }
