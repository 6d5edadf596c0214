"""Depth-Anything V2 in plain float32 PyTorch, from the original checkpoint's
keys (github.com/DepthAnything/Depth-Anything-V2 ``depth_anything_v2/dpt.py``
with DINOv2's ViT).

Departures, shared with the system under test, so that ``correct`` cannot
see them:

- the learned position embedding is resized to the patch grid by size
  (bicubic, align_corners=False, no antialias), where DINOv2's
  ``interpolate_pos_encoding`` passes a scale factor with a 0.1 offset;
- the blocks that feed the neck are the end of each quarter (5, 11, 17, 23
  at ViT-L, the port's ``stage_taps``), where ``dpt.py`` sets
  ``intermediate_layer_idx['vitl']`` to [4, 11, 17, 23]. The operations are
  the same; with trained weights the depth would differ."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv2d, exact, fusion, head, preprocess, resample, taps, tokens_to_map, vit_block, weight

MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)
RESAMPLE = (4, 2, 1, 0.5)  # depth_head.resize_layers: ConvTranspose x4, x2, Identity, Conv stride 2


def position_embedding(sd: dict, grid_hw) -> torch.Tensor:
    """(1, 1 + gh*gw, F): the cls position and the patch positions resized bicubically to the grid."""
    pos = weight(sd, "pretrained.pos_embed")
    f = pos.shape[-1]
    base = int(round((pos.shape[1] - 1) ** 0.5))
    patch = pos[:, 1:].reshape(1, base, base, f).permute(0, 3, 1, 2)
    if tuple(grid_hw) != (base, base):
        patch = F.interpolate(patch, size=tuple(grid_hw), mode="bicubic", align_corners=False)
    return torch.cat([pos[:, :1], patch.flatten(2).transpose(1, 2)], dim=1)


@torch.no_grad()
def forward(sd: dict, config: dict, frames_u8: torch.Tensor, scaled_hw, q=exact) -> torch.Tensor:
    """(B, H, W, 3) RGB uint8 frames -> (B, h, w) float32 depth at ``scaled_hw``;
    ``q`` rounds every product's operands (``exact``: none)."""
    heads = config["num_heads"]
    p = config["patch_size_px"]
    x = preprocess(frames_u8, scaled_hw, MEAN_RGB, STD_RGB)
    x = conv2d(x, weight(sd, "pretrained.patch_embed.proj.weight"), weight(sd, "pretrained.patch_embed.proj.bias"), q,
               stride=p)
    b, _, gh, gw = x.shape
    x = torch.cat([weight(sd, "pretrained.cls_token").expand(b, 1, -1), x.flatten(2).transpose(1, 2)], dim=1)
    x = x + position_embedding(sd, (gh, gw))
    outputs = []
    tapped = taps(config["num_blocks"])
    for i in range(config["num_blocks"]):
        pre = f"pretrained.blocks.{i}"
        x = vit_block(x, sd, pre, heads, ("ls1.gamma", "ls2.gamma"), weight(sd, f"{pre}.attn.qkv.bias"), q=q)
        if i in tapped:
            outputs.append(F.layer_norm(x, (x.shape[-1],), weight(sd, "pretrained.norm.weight"),
                                        weight(sd, "pretrained.norm.bias"), 1e-6))
    layers_rn = []
    for i, (t, scale) in enumerate(zip(outputs, RESAMPLE)):
        m = tokens_to_map(t[:, 1:], (gh, gw))  # readout 'ignore': the cls token is dropped
        m = conv2d(m, weight(sd, f"depth_head.projects.{i}.weight"), weight(sd, f"depth_head.projects.{i}.bias"), q)
        if scale != 1:
            m = resample(m, weight(sd, f"depth_head.resize_layers.{i}.weight"),
                         weight(sd, f"depth_head.resize_layers.{i}.bias"), scale, q)
        layers_rn.append(conv2d(m, weight(sd, f"depth_head.scratch.layer{i + 1}_rn.weight"), None, q, padding=1))
    path = fusion(layers_rn, sd, "depth_head.scratch.refinenet", q)
    return head(path, sd, "depth_head.scratch.output_conv1", "depth_head.scratch.output_conv2.0",
                "depth_head.scratch.output_conv2.2", scaled_hw, q)
