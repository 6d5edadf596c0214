"""MiDaS v3.1 BEiT: the whole forward pipeline, patch embed (16 px) -> BEiT
encoder (relative-position bias, 4 taps) -> reassembly with readout
projection -> fusion -> head (fixed 2x upsample), and its family spec.

The counterpart of ``muggled_dpt_tpu/models/beit_family.py``."""

from __future__ import annotations

import torch
from torch import nn

from ..checkpoints.beit import REASSEMBLY_SCALES
from ..ops.nn import patchify_embed
from .beit import BEiTEncoder, bias_build_bytes, compute_bias_stack, padded_tokens
from .dpt_neck import FusionBlock, Head, ReassembleStage, fusion_forward

# MiDaS normalization
MEAN_RGB = (0.5, 0.5, 0.5)
STD_RGB = (0.5, 0.5, 0.5)
HEAD_UPSAMPLE = 2.0  # MiDaS's head upsamples by a fixed 2x


class BEiTDPT(nn.Module):
    """Built from a config dict of ``checkpoints.beit.get_config_from_state_dict``.
    ``enable_optimizations`` (default True) sends attention through the
    biased fused-qkv flash kernel; False runs the plain attention path."""

    def __init__(self, config: dict, device=None):
        super().__init__()
        f = config["features_per_token"]
        p = config["patch_size_px"]
        cf = config["fusion_channels"]
        self.patch_size_px = p
        self.patch_embed = nn.Conv2d(3, f, p, stride=p, device=device)
        self.encoder = BEiTEncoder(
            f,
            config["num_heads"],
            config["num_blocks"],
            config["base_patch_grid_hw"],
            use_kernel=config.get("enable_optimizations", True),
            device=device,
        )
        self.reassemble = nn.ModuleList(
            ReassembleStage(f, r, cf, s, readout="project", device=device)
            for r, s in zip(config["reassembly_features_list"], REASSEMBLY_SCALES)
        )
        self.fusion = nn.ModuleList(FusionBlock(cf, top=(i == 3), device=device) for i in range(4))
        self.head = Head(cf, HEAD_UPSAMPLE, False, device=device)

    def forward(self, image_nchw, aux=None):
        """Normalized (B, 3, H, W) image, H and W multiples of the patch size
        -> (B, H, W) depth. aux: the grid's cached bias stack from
        ``make_aux``, or None to build each block's bias inline."""
        tokens, grid = patchify_embed(image_nchw, self.patch_embed.weight, self.patch_embed.bias)
        stages = self.encoder(tokens, grid, aux)
        maps = [stage(t, grid) for stage, t in zip(self.reassemble, stages)]
        return self.head(fusion_forward(maps, self.fusion))

    def forward_capture(self, image_nchw, aux=None):
        """``forward`` on the plain attention path -> (depth, internals):
        the encoder's ``block_tokens`` and ``attention`` plus
        ``reassembly_maps`` (4 maps) and ``fused_map``, both NCHW (the JAX
        package's maps are NHWC)."""
        tokens, grid = patchify_embed(image_nchw, self.patch_embed.weight, self.patch_embed.bias)
        stages, internals = self.encoder.forward_capture(tokens, grid, aux)
        internals["reassembly_maps"] = [stage(t, grid) for stage, t in zip(self.reassemble, stages)]
        internals["fused_map"] = fusion_forward(internals["reassembly_maps"], self.fusion)
        return self.head(internals["fused_map"]), internals


def make_aux(net: BEiTDPT, grid_hw, dtype) -> torch.Tensor:
    """The grid's (L, H, Np, Np) bias stack in the model's dtype, Np = N
    rounded up to 8 with zero pads; the kernel reads its [:N, :N] corner."""
    enc = net.encoder
    return compute_bias_stack(enc.relpos_lut, enc.base_grid_hw, grid_hw, padded_tokens(grid_hw), dtype)


def aux_bytes_estimate(config: dict, grid_hw, dtype) -> int:
    """Peak device bytes of ``make_aux`` for a grid: the stack it keeps plus
    its build's transients."""
    elem = torch.empty((), dtype=dtype).element_size()
    return bias_build_bytes(config["num_blocks"], config["num_heads"], grid_hw, elem)


def family_spec(config_dict: dict) -> dict:
    patch_px = config_dict["patch_size_px"]
    return {
        "mean_rgb": MEAN_RGB,
        "std_rgb": STD_RGB,
        "patch_size_px": patch_px,
        "tiling_size": 2 * patch_px,
        "default_size_px": config_dict["base_patch_grid_hw"][0] * patch_px,
        "make_aux": make_aux,
        "aux_bytes_estimate": aux_bytes_estimate,
        "forward_capture": BEiTDPT.forward_capture,
        "head_upsample": HEAD_UPSAMPLE,
    }
