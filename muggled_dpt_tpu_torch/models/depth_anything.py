"""Depth-Anything V2: the whole forward pipeline, patch embed -> DINOv2
encoder (4 taps) -> reassembly -> fusion -> monocular head.

The counterpart of ``muggled_dpt_tpu/models/depth_anything.py`` for V2."""

from __future__ import annotations

from torch import nn

from ..checkpoints.depth_anything import REASSEMBLY_SCALES
from ..ops.nn import patchify_embed
from .dinov2 import DinoV2Encoder
from .dpt_neck import FusionBlock, Head, ReassembleStage, fusion_forward

# ImageNet normalization
MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)


class DepthAnything(nn.Module):
    """Built from a config dict of ``checkpoints.depth_anything.get_config_from_state_dict``.
    ``enable_optimizations`` (default True) sends attention through the
    fused-qkv flash kernel; False runs the plain attention path."""

    def __init__(self, config: dict, device=None):
        super().__init__()
        if config.get("is_giant", False):
            raise NotImplementedError("SwiGLU (ViT-Giant) blocks are not ported yet: ROADMAP Queue A item 7")
        f = config["features_per_token"]
        p = config["patch_size_px"]
        cf = config["fusion_channels"]
        self.patch_size_px = p
        self.patch_embed = nn.Conv2d(3, f, p, stride=p, device=device)
        self.encoder = DinoV2Encoder(
            f,
            config["num_heads"],
            config["num_blocks"],
            config["base_patch_grid_hw"],
            use_kernel=config.get("enable_optimizations", True),
            device=device,
        )
        self.reassemble = nn.ModuleList(
            ReassembleStage(f, r, cf, s, device=device)
            for r, s in zip(config["reassembly_features_list"], REASSEMBLY_SCALES)
        )
        self.fusion = nn.ModuleList(FusionBlock(cf, top=(i == 3), device=device) for i in range(4))
        self.head = Head(cf, p / 8, config.get("is_metric", False), device=device)

    def forward(self, image_nchw, aux=None):
        """Normalized (B, 3, H, W) image, H and W multiples of the patch size
        -> (B, H, W) depth. ``aux`` is the facade's per-grid cache entry,
        which this family does not use (it has no ``make_aux``)."""
        tokens, grid = patchify_embed(image_nchw, self.patch_embed.weight, self.patch_embed.bias)
        stages = self.encoder(tokens, grid)
        maps = [stage(t, grid) for stage, t in zip(self.reassemble, stages)]
        return self.head(fusion_forward(maps, self.fusion))
