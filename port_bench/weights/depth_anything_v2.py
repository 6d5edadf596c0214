"""Depth-Anything V2 (DINOv2 ViT + DPT head) in the original checkpoint's
layout: ``pretrained.*`` and ``depth_head.*`` keys and torch shapes, as
``depth_anything_v2/dpt.py`` of github.com/DepthAnything/Depth-Anything-V2
saves them."""

from __future__ import annotations

from . import conv_scale, draw


def layout(config: dict) -> list:
    """(key, shape, scale, shift) of every tensor the model reads."""
    f = config["features_per_token"]
    p = config["patch_size_px"]
    gh, gw = config["base_patch_grid_hw"]
    hidden = config["mlp_hidden"]
    reassembly = config["reassembly_features_list"]
    cf = config["fusion_channels"]
    w = 0.05
    out = [
        ("pretrained.cls_token", (1, 1, f), w, 0.0),
        ("pretrained.pos_embed", (1, 1 + gh * gw, f), w, 0.0),
        ("pretrained.patch_embed.proj.weight", (f, 3, p, p), w, 0.0),
        ("pretrained.patch_embed.proj.bias", (f,), w, 0.0),
        ("pretrained.norm.weight", (f,), w, 1.0),
        ("pretrained.norm.bias", (f,), w, 0.0),
    ]
    for i in range(config["num_blocks"]):
        pre = f"pretrained.blocks.{i}"
        out += [
            (f"{pre}.norm1.weight", (f,), w, 1.0),
            (f"{pre}.norm1.bias", (f,), w, 0.0),
            (f"{pre}.attn.qkv.weight", (3 * f, f), w, 0.0),
            (f"{pre}.attn.qkv.bias", (3 * f,), w, 0.0),
            (f"{pre}.attn.proj.weight", (f, f), w, 0.0),
            (f"{pre}.attn.proj.bias", (f,), w, 0.0),
            (f"{pre}.ls1.gamma", (f,), w, 1.0),
            (f"{pre}.norm2.weight", (f,), w, 1.0),
            (f"{pre}.norm2.bias", (f,), w, 0.0),
            (f"{pre}.mlp.fc1.weight", (hidden, f), w, 0.0),
            (f"{pre}.mlp.fc1.bias", (hidden,), w, 0.0),
            (f"{pre}.mlp.fc2.weight", (f, hidden), w, 0.0),
            (f"{pre}.mlp.fc2.bias", (f,), w, 0.0),
            (f"{pre}.ls2.gamma", (f,), w, 1.0),
        ]
    for i, r in enumerate(reassembly):
        out += [
            (f"depth_head.projects.{i}.weight", (r, f, 1, 1), w, 0.0),
            (f"depth_head.projects.{i}.bias", (r,), w, 0.0),
            (f"depth_head.scratch.layer{i + 1}_rn.weight", (cf, r, 3, 3), conv_scale(r, 3), 0.0),
        ]
    for i, k in ((0, 4), (1, 2), (3, 3)):
        r = reassembly[i]
        out += [
            (f"depth_head.resize_layers.{i}.weight", (r, r, k, k), w, 0.0),
            (f"depth_head.resize_layers.{i}.bias", (r,), w, 0.0),
        ]
    for k in range(1, 5):
        pre = f"depth_head.scratch.refinenet{k}"
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
        ("depth_head.scratch.output_conv1.weight", (ch, cf, 3, 3), conv_scale(cf, 3), 0.0),
        ("depth_head.scratch.output_conv1.bias", (ch,), w, 0.0),
        ("depth_head.scratch.output_conv2.0.weight", (32, ch, 3, 3), conv_scale(ch, 3), 0.0),
        ("depth_head.scratch.output_conv2.0.bias", (32,), w, 0.0),
        ("depth_head.scratch.output_conv2.2.weight", (1, 32, 1, 1), 0.3 * conv_scale(32, 1), 0.0),
        # a positive final bias keeps the synthetic depth mostly above the ReLU clip
        ("depth_head.scratch.output_conv2.2.bias", (1,), w, 2.0),
    ]
    return out


def generate(config: dict, seed: int, device, dtype) -> dict:
    """The original-layout state dict of ``config``, made on ``device`` in ``dtype``."""
    return draw(layout(config), seed, device, dtype)
