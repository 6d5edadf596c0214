"""MiDaS v3.1 BEiT (``dpt_beit_large_512``) in the original checkpoint's
layout: ``pretrained.model.*``, ``pretrained.act_postprocess*`` and
``scratch.*`` keys and torch shapes, as github.com/isl-org/MiDaS saves them.
The stored ``relative_position_index`` buffers are left out: the port drops
them and the reference rebuilds the index."""

from __future__ import annotations

from . import conv_scale, draw


def layout(config: dict) -> list:
    """(key, shape, scale, shift) of every tensor the model reads."""
    f = config["features_per_token"]
    p = config["patch_size_px"]
    gh, gw = config["base_patch_grid_hw"]
    heads = config["num_heads"]
    hidden = config["mlp_hidden"]
    reassembly = config["reassembly_features_list"]
    cf = config["fusion_channels"]
    lut_rows = (2 * gh - 1) * (2 * gw - 1) + 3
    w = 0.05
    out = [
        ("pretrained.model.cls_token", (1, 1, f), w, 0.0),
        ("pretrained.model.patch_embed.proj.weight", (f, 3, p, p), w, 0.0),
        ("pretrained.model.patch_embed.proj.bias", (f,), w, 0.0),
    ]
    for i in range(config["num_blocks"]):
        pre = f"pretrained.model.blocks.{i}"
        out += [
            (f"{pre}.norm1.weight", (f,), w, 1.0),
            (f"{pre}.norm1.bias", (f,), w, 0.0),
            (f"{pre}.attn.qkv.weight", (3 * f, f), w, 0.0),
            (f"{pre}.attn.q_bias", (f,), w, 0.0),
            (f"{pre}.attn.v_bias", (f,), w, 0.0),
            (f"{pre}.attn.proj.weight", (f, f), w, 0.0),
            (f"{pre}.attn.proj.bias", (f,), w, 0.0),
            (f"{pre}.attn.relative_position_bias_table", (lut_rows, heads), 0.2, 0.0),
            (f"{pre}.gamma_1", (f,), w, 1.0),
            (f"{pre}.gamma_2", (f,), w, 1.0),
            (f"{pre}.norm2.weight", (f,), w, 1.0),
            (f"{pre}.norm2.bias", (f,), w, 0.0),
            (f"{pre}.mlp.fc1.weight", (hidden, f), w, 0.0),
            (f"{pre}.mlp.fc1.bias", (hidden,), w, 0.0),
            (f"{pre}.mlp.fc2.weight", (f, hidden), w, 0.0),
            (f"{pre}.mlp.fc2.bias", (f,), w, 0.0),
        ]
    for s, r in zip(range(1, 5), reassembly):
        pre = f"pretrained.act_postprocess{s}"
        out += [
            (f"{pre}.0.project.0.weight", (f, 2 * f), conv_scale(2 * f, 1), 0.0),
            (f"{pre}.0.project.0.bias", (f,), w, 0.0),
            (f"{pre}.3.weight", (r, f, 1, 1), conv_scale(f, 1), 0.0),
            (f"{pre}.3.bias", (r,), w, 0.0),
            (f"scratch.layer{s}_rn.weight", (cf, r, 3, 3), conv_scale(r, 3), 0.0),
        ]
    for s, k in ((1, 4), (2, 2), (4, 3)):
        r = reassembly[s - 1]
        out += [
            (f"pretrained.act_postprocess{s}.4.weight", (r, r, k, k), conv_scale(r, k), 0.0),
            (f"pretrained.act_postprocess{s}.4.bias", (r,), w, 0.0),
        ]
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
