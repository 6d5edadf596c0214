"""MiDaS v3.1 SwinV2 (``dpt_swin2_large_384``) in the original checkpoint's
layout: ``pretrained.model.patch_embed.*``, ``pretrained.model.layers.<s>.blocks.<i>.*``,
``pretrained.model.layers.<s>.downsample.*`` and ``scratch.*`` keys and
torch shapes, as github.com/isl-org/MiDaS saves them, at the scales of
``muggled_dpt_tpu_torch/checkpoints/swinv2.py:random_original_state_dict``.

Of the stored buffers only the first block's ``attn_mask`` (nW, A, A) at the
base grid is kept: the port reads the window and the base grid from its
shape, and nothing reads its values (zeros here). The
``relative_coords_table`` and ``relative_position_index`` buffers are left
out: the port and the reference rebuild both per grid. So is the backbone's
final ``norm``, which feeds nothing the neck reads."""

from __future__ import annotations

import math

from . import conv_scale, draw

CPB_HIDDEN = 512


def layout(config: dict) -> list:
    """(key, shape, scale, shift) of every tensor the model reads."""
    feats, heads, layers = config["features_per_stage"], config["heads_per_stage"], config["layers_per_stage"]
    p = config["patch_size_px"]
    g = config["base_patch_grid_hw"][0]
    win = config["window_size_hw"][0]
    cf = config["fusion_channels"]
    w = 0.05
    f0 = feats[0]
    out = [
        ("pretrained.model.patch_embed.proj.weight", (f0, 3, p, p), w, 0.0),
        ("pretrained.model.patch_embed.proj.bias", (f0,), w, 0.0),
        ("pretrained.model.patch_embed.norm.weight", (f0,), w, 1.0),
        ("pretrained.model.patch_embed.norm.bias", (f0,), w, 0.0),
    ]
    for s in range(4):
        f, h = feats[s], heads[s]
        for b in range(layers[s]):
            pre = f"pretrained.model.layers.{s}.blocks.{b}"
            out += [
                (f"{pre}.attn.qkv.weight", (3 * f, f), w, 0.0),
                (f"{pre}.attn.q_bias", (f,), w, 0.0),
                (f"{pre}.attn.v_bias", (f,), w, 0.0),
                (f"{pre}.attn.proj.weight", (f, f), w, 0.0),
                (f"{pre}.attn.proj.bias", (f,), w, 0.0),
                (f"{pre}.attn.logit_scale", (h, 1, 1), w, math.log(10.0)),
                (f"{pre}.attn.cpb_mlp.0.weight", (CPB_HIDDEN, 2), 0.5, 0.0),
                (f"{pre}.attn.cpb_mlp.0.bias", (CPB_HIDDEN,), w, 0.0),
                (f"{pre}.attn.cpb_mlp.2.weight", (h, CPB_HIDDEN), w, 0.0),
                (f"{pre}.norm1.weight", (f,), w, 1.0),
                (f"{pre}.norm1.bias", (f,), w, 0.0),
                (f"{pre}.norm2.weight", (f,), w, 1.0),
                (f"{pre}.norm2.bias", (f,), w, 0.0),
                (f"{pre}.mlp.fc1.weight", (4 * f, f), w, 0.0),
                (f"{pre}.mlp.fc1.bias", (4 * f,), w, 0.0),
                (f"{pre}.mlp.fc2.weight", (f, 4 * f), w, 0.0),
                (f"{pre}.mlp.fc2.bias", (f,), w, 0.0),
            ]
        if s < 3:
            pre = f"pretrained.model.layers.{s}.downsample"
            out += [
                (f"{pre}.reduction.weight", (feats[s + 1], 4 * f), w, 0.0),
                (f"{pre}.norm.weight", (feats[s + 1],), w, 1.0),
                (f"{pre}.norm.bias", (feats[s + 1],), w, 0.0),
            ]
    area = win * win
    out.append(("pretrained.model.layers.0.blocks.1.attn_mask", ((g // win) ** 2, area, area), 0.0, 0.0))
    for i, f in enumerate(feats, start=1):
        out.append((f"scratch.layer{i}_rn.weight", (cf, f, 3, 3), conv_scale(f, 3), 0.0))
    for k in range(1, 5):
        pre = f"scratch.refinenet{k}"
        for unit in (1, 2):
            for conv in (1, 2):
                out += [
                    (f"{pre}.resConfUnit{unit}.conv{conv}.weight", (cf, cf, 3, 3), conv_scale(cf, 3), 0.0),
                    (f"{pre}.resConfUnit{unit}.conv{conv}.bias", (cf,), w, 0.0),
                ]
        out += [
            (f"{pre}.out_conv.weight", (cf, cf, 1, 1), conv_scale(cf, 1), 0.0),
            (f"{pre}.out_conv.bias", (cf,), w, 0.0),
        ]
    ch = cf // 2
    out += [
        ("scratch.output_conv.0.weight", (ch, cf, 3, 3), conv_scale(cf, 3), 0.0),
        ("scratch.output_conv.0.bias", (ch,), w, 0.0),
        ("scratch.output_conv.2.weight", (32, ch, 3, 3), conv_scale(ch, 3), 0.0),
        ("scratch.output_conv.2.bias", (32,), w, 0.0),
        ("scratch.output_conv.4.weight", (1, 32, 1, 1), 0.3 * conv_scale(32, 1), 0.0),
        # a positive final bias keeps the synthetic depth mostly above the ReLU clip
        ("scratch.output_conv.4.bias", (1,), w, 2.0),
    ]
    return out


def generate(config: dict, seed: int, device, dtype) -> dict:
    """The original-layout state dict of ``config``, made on ``device`` in ``dtype``."""
    return draw(layout(config), seed, device, dtype)
