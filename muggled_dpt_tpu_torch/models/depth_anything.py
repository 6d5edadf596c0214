"""Depth-Anything V1 and V2: the whole forward pipeline, patch embed ->
DINOv2 encoder (4 taps) -> reassembly -> fusion -> monocular head.

The counterpart of ``muggled_dpt_tpu/models/depth_anything.py``. V1 differs
from V2 only in its taps (the last 4 blocks, not the end of each quarter) and
has no ViT-Giant (SwiGLU) or metric variant; the V1 factory forces both
flags off."""

from __future__ import annotations

from torch import nn

from ..checkpoints.depth_anything import REASSEMBLY_SCALES
from ..ops.nn import patchify_embed
from .dinov2 import DinoV2Encoder, last4_taps, stage_taps
from .dpt_neck import FusionBlock, Head, ReassembleStage, fusion_forward

# ImageNet normalization
MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)


def encoder_taps(num_blocks: int, version: int) -> tuple[int, ...]:
    """The blocks whose outputs feed the neck: V2 the end of each quarter, V1 the last 4."""
    if version not in (1, 2):
        raise ValueError(f"Depth-Anything version must be 1 or 2, got {version}")
    return stage_taps(num_blocks) if version == 2 else last4_taps(num_blocks)


class DepthAnything(nn.Module):
    """Built from a config dict of ``checkpoints.depth_anything.get_config_from_state_dict``
    and a ``version`` (1 or 2), which picks the encoder taps; the config's
    ``is_giant`` picks the SwiGLU blocks. ``enable_optimizations`` (default
    True) sends attention through the fused-qkv flash kernel; False runs the
    plain attention path."""

    def __init__(self, config: dict, version: int = 2, device=None):
        super().__init__()
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
            is_giant=config.get("is_giant", False),
            taps=encoder_taps(config["num_blocks"], version),
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

    def forward_capture(self, image_nchw, aux=None):
        """``forward`` on the plain attention path -> (depth, internals):
        the encoder's ``block_tokens`` and ``attention`` plus
        ``reassembly_maps`` (4 maps) and ``fused_map``, both NCHW (the JAX
        package's maps are NHWC)."""
        tokens, grid = patchify_embed(image_nchw, self.patch_embed.weight, self.patch_embed.bias)
        stages, internals = self.encoder.forward_capture(tokens, grid)
        internals["reassembly_maps"] = [stage(t, grid) for stage, t in zip(self.reassemble, stages)]
        internals["fused_map"] = fusion_forward(internals["reassembly_maps"], self.fusion)
        return self.head(internals["fused_map"]), internals
