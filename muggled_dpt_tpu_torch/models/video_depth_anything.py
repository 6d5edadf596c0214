"""Video Depth Anything: Depth-Anything V2's DINOv2 encoder and DPT neck with
four temporal motion modules in the neck, so the frames of a clip are
computed together (github.com/DepthAnything/Video-Depth-Anything
``video_depth_anything/video_depth.py``, ``dpt_temporal.py``;
arXiv:2501.12375).

A forward's B frames are one clip in time order, at most ``num_frames``
(32). The encoder runs over all of them at the published taps
(``intermediate_layer_idx``: [4, 11, 17, 23] at ViT-L). The temporal modules
(``models/temporal.py``) sit where ``DPTHeadTemporal`` puts them: on the
third and fourth reassembly maps after their resample and before their 3x3
fuse convs, and on the outputs of the fourth and third fusion blocks. The
net's own forward runs them between the reassembly stages, fusion blocks and
head, so a stage hands its map on before the fuse conv, and the fusion block
that takes the map runs that conv (``ReassembleStage(fuse=False)``,
``FusionBlock(fuse_channels=...)``): the same arithmetic, and each temporal
module outside every other module of the neck."""

from __future__ import annotations

from torch import nn

from ..checkpoints.depth_anything import REASSEMBLY_SCALES
from ..ops.nn import patchify_embed
from ..utils.observability import trace_span
from .depth_anything import MEAN_RGB, STD_RGB
from .dinov2 import DinoV2Encoder, stage_taps
from .dpt_neck import FusionBlock, Head, ReassembleStage
from .temporal import TemporalModule

PUBLISHED_TAPS = {12: (2, 5, 8, 11), 24: (4, 11, 17, 23)}  # intermediate_layer_idx by depth: vits/vitb, vitl
TEMPORAL_MAPS = (2, 3)  # the reassembly maps that a temporal module takes before their fuse conv


def published_taps(num_blocks: int) -> tuple[int, ...]:
    """The blocks whose outputs feed the neck: the published ones, else (a
    depth no released model has) the end of each quarter."""
    return PUBLISHED_TAPS.get(num_blocks, stage_taps(num_blocks))


class VideoDepthAnything(nn.Module):
    """Built from a config dict of ``checkpoints.video_depth_anything.get_config_from_state_dict``."""

    def __init__(self, config: dict, device=None):
        super().__init__()
        f = config["features_per_token"]
        p = config["patch_size_px"]
        cf = config["fusion_channels"]
        reassembly = config["reassembly_features_list"]
        self.patch_size_px = p
        self.num_frames = config["num_frames"]
        use_kernel = config.get("enable_optimizations", True)
        self.patch_embed = nn.Conv2d(3, f, p, stride=p, device=device)
        self.encoder = DinoV2Encoder(f, config["num_heads"], config["num_blocks"], config["base_patch_grid_hw"],
                                     use_kernel=use_kernel, is_giant=config.get("is_giant", False),
                                     taps=config["encoder_taps"], device=device)
        self.reassemble = nn.ModuleList(
            ReassembleStage(f, r, cf, s, fuse=i not in TEMPORAL_MAPS, device=device)
            for i, (r, s) in enumerate(zip(reassembly, REASSEMBLY_SCALES))
        )
        self.fusion = nn.ModuleList(
            FusionBlock(cf, top=(i == 3), use_kernel=use_kernel,
                        fuse_channels=reassembly[i] if i in TEMPORAL_MAPS else None, device=device)
            for i in range(4)
        )
        self.temporal = nn.ModuleList(
            TemporalModule(c, config["temporal_heads"], config["temporal_attention_blocks"], self.num_frames,
                           device=device)
            for c in config["temporal_channels"]
        )
        self.head = Head(cf, p / 8, False, use_kernel=use_kernel, device=device)

    def forward(self, image_nchw, aux=None):
        """Normalized (T, 3, H, W) frames of one clip, T <= ``num_frames``, H
        and W multiples of the patch size -> (T, H, W) depth. ``aux``: unused
        (the family has no ``make_aux``)."""
        frames = image_nchw.shape[0]
        if frames > self.num_frames:
            raise ValueError(f"a clip holds at most {self.num_frames} frames, got {frames}")
        with trace_span("encoder"):
            tokens, grid = patchify_embed(image_nchw, self.patch_embed.weight, self.patch_embed.bias)
            stages = self.encoder(tokens, grid)
        with trace_span("neck"):
            upx4, upx2, noscale, downx2 = (stage(t, grid) for stage, t in zip(self.reassemble, stages))
            noscale = self.temporal[0](noscale, frames)
            downx2 = self.temporal[1](downx2, frames)
            path = self.temporal[2](self.fusion[3](downx2), frames)
            path = self.temporal[3](self.fusion[2](noscale, path), frames)
            return self.head(self.fusion[0](upx4, self.fusion[1](upx2, path)))


def family_spec(config_dict: dict) -> dict:
    patch_px = config_dict["patch_size_px"]
    return {
        "mean_rgb": MEAN_RGB,
        "std_rgb": STD_RGB,
        "patch_size_px": patch_px,
        "tiling_size": 2 * patch_px,
        "default_size_px": config_dict["base_patch_grid_hw"][0] * patch_px,
        "head_upsample": patch_px / 8,
    }
