"""MiDaS v3.1 BEiT (``dpt_beit_large_512``) in plain float32 PyTorch, from
the original checkpoint's keys (github.com/isl-org/MiDaS
``midas/backbones/beit.py``, ``midas/dpt_depth.py``, ``midas/blocks.py``;
timm's BEiT block).

The relative-position bias is worked out here from each block's original
table: its token part resized bilinearly to the grid's (2gh-1, 2gw-1) as
MiDaS's ``_get_rel_pos_bias`` does, the three cls rows kept, then gathered by
timm's ``gen_relative_position_index`` for the grid."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv2d, exact, fusion, head, linear, preprocess, resample, taps, tokens_to_map, vit_block, weight

MEAN_RGB = (0.5, 0.5, 0.5)
STD_RGB = (0.5, 0.5, 0.5)
RESAMPLE = (4, 2, 1, 0.5)  # act_postprocess{1..4}.4: ConvTranspose x4, x2, Identity, Conv stride 2


def relative_position_index(grid_hw, device) -> torch.Tensor:
    """timm's ``gen_relative_position_index``: (N, N) int64, N = gh*gw + 1,
    with the cls-to-token, token-to-cls and cls-to-cls ids last."""
    gh, gw = grid_hw
    coords = torch.stack(torch.meshgrid(torch.arange(gh, device=device), torch.arange(gw, device=device),
                                        indexing="ij")).flatten(1)  # (2, gh*gw)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)  # (n, n, 2)
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    num = (2 * gh - 1) * (2 * gw - 1) + 3
    n = gh * gw + 1
    index = torch.zeros(n, n, dtype=torch.int64, device=device)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num - 3
    index[0:, 0] = num - 2
    index[0, 0] = num - 1
    return index


def relative_position_bias(table: torch.Tensor, base_grid_hw, grid_hw, index: torch.Tensor) -> torch.Tensor:
    """(H, N, N) bias of one block from its (R, H) table for the grid."""
    (bh, bw), (gh, gw) = base_grid_hw, grid_hw
    heads = table.shape[1]
    old_h, old_w, new_h, new_w = 2 * bh - 1, 2 * bw - 1, 2 * gh - 1, 2 * gw - 1
    tokens = table[: old_h * old_w]
    if (new_h, new_w) != (old_h, old_w):
        grid = tokens.reshape(1, old_h, old_w, heads).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(new_h, new_w), mode="bilinear", align_corners=False)
        tokens = grid.permute(0, 2, 3, 1).reshape(new_h * new_w, heads)
    full = torch.cat([tokens, table[old_h * old_w:]], dim=0)  # (R', H)
    n = index.shape[0]
    return full[index.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1).contiguous()


@torch.no_grad()
def forward(sd: dict, config: dict, frames_u8: torch.Tensor, scaled_hw, q=exact) -> torch.Tensor:
    """(B, H, W, 3) RGB uint8 frames -> (B, h, w) float32 depth at ``scaled_hw``;
    ``q`` rounds every product's operands (``exact``: none)."""
    heads = config["num_heads"]
    p = config["patch_size_px"]
    base = tuple(config["base_patch_grid_hw"])
    x = preprocess(frames_u8, scaled_hw, MEAN_RGB, STD_RGB)
    x = conv2d(x, weight(sd, "pretrained.model.patch_embed.proj.weight"),
               weight(sd, "pretrained.model.patch_embed.proj.bias"), q, stride=p)
    b, _, gh, gw = x.shape
    x = torch.cat([weight(sd, "pretrained.model.cls_token").expand(b, 1, -1), x.flatten(2).transpose(1, 2)], dim=1)
    index = relative_position_index((gh, gw), x.device)
    outputs = []
    tapped = taps(config["num_blocks"])
    for i in range(config["num_blocks"]):
        pre = f"pretrained.model.blocks.{i}"
        q_bias, v_bias = weight(sd, f"{pre}.attn.q_bias"), weight(sd, f"{pre}.attn.v_bias")
        qkv_bias = torch.cat([q_bias, torch.zeros_like(q_bias), v_bias])  # BEiT has no key bias
        bias = relative_position_bias(weight(sd, f"{pre}.attn.relative_position_bias_table"), base, (gh, gw), index)
        x = vit_block(x, sd, pre, heads, ("gamma_1", "gamma_2"), qkv_bias, bias, q)
        del bias
        if i in tapped:
            outputs.append(x)
    layers_rn = []
    for s, (t, scale) in enumerate(zip(outputs, RESAMPLE), start=1):
        pre = f"pretrained.act_postprocess{s}"
        patch = t[:, 1:]
        readout = torch.cat([patch, t[:, :1].expand_as(patch)], dim=-1)  # readout 'project'
        patch = F.gelu(linear(readout, weight(sd, f"{pre}.0.project.0.weight"), weight(sd, f"{pre}.0.project.0.bias"), q))
        m = conv2d(tokens_to_map(patch, (gh, gw)), weight(sd, f"{pre}.3.weight"), weight(sd, f"{pre}.3.bias"), q)
        if scale != 1:
            m = resample(m, weight(sd, f"{pre}.4.weight"), weight(sd, f"{pre}.4.bias"), scale, q)
        layers_rn.append(conv2d(m, weight(sd, f"scratch.layer{s}_rn.weight"), None, q, padding=1))
    path = fusion(layers_rn, sd, "scratch.refinenet", q)
    return head(path, sd, "scratch.output_conv.0", "scratch.output_conv.2", "scratch.output_conv.4", scaled_hw, q)
