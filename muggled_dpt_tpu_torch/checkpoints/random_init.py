"""Synthetic original-format Depth-Anything state dicts, from numpy alone.

The draws are the same as the JAX package's generator
(``muggled_dpt_tpu/checkpoints/random_init.py``), so one seed gives a
byte-identical state dict in both packages: the tests feed it to both and
compare their outputs, and ``chip_smoke.py`` builds its full-width model from
it. This copy exists because importing anything from the JAX package imports
jax, which the port must not need."""

from __future__ import annotations

import math

import numpy as np


def swiglu_hidden(features: int, ratio: float = 4.0) -> int:
    """DA-V2 giant hidden sizing."""
    return 8 * ((int(features * ratio * 2 / 3) + 7) // 8)


def random_original_depth_anything_state_dict(config: dict, seed: int = 0) -> dict:
    """Original Depth-Anything checkpoint layout (torch key names and shapes)
    as numpy float32 arrays filled with small random values."""
    rng = np.random.default_rng(seed)
    f = config["features_per_token"]
    p = config["patch_size_px"]
    gh, gw = config["base_patch_grid_hw"]
    n_blocks = config["num_blocks"]
    reassembly = config["reassembly_features_list"]
    cf = config["fusion_channels"]
    is_giant = config.get("is_giant", False)

    def w(*shape, scale=0.05):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    sd = {
        "pretrained.cls_token": w(1, 1, f),
        "pretrained.pos_embed": w(1, 1 + gh * gw, f),
        "pretrained.mask_token": w(1, f),  # unused, exercises key-skipping
        "pretrained.patch_embed.proj.weight": w(f, 3, p, p),
        "pretrained.patch_embed.proj.bias": w(f),
        "pretrained.norm.weight": 1.0 + w(f),
        "pretrained.norm.bias": w(f),
    }
    hidden = int(round(4.0 * f))
    for i in range(n_blocks):
        pre = f"pretrained.blocks.{i}"
        sd[f"{pre}.norm1.weight"] = 1.0 + w(f)
        sd[f"{pre}.norm1.bias"] = w(f)
        sd[f"{pre}.attn.qkv.weight"] = w(3 * f, f)
        sd[f"{pre}.attn.qkv.bias"] = w(3 * f)
        sd[f"{pre}.attn.proj.weight"] = w(f, f)
        sd[f"{pre}.attn.proj.bias"] = w(f)
        sd[f"{pre}.ls1.gamma"] = 1.0 + w(f)
        sd[f"{pre}.norm2.weight"] = 1.0 + w(f)
        sd[f"{pre}.norm2.bias"] = w(f)
        sd[f"{pre}.ls2.gamma"] = 1.0 + w(f)
        if is_giant:
            hs = swiglu_hidden(f)
            sd[f"{pre}.mlp.w12.weight"] = w(2 * hs, f)
            sd[f"{pre}.mlp.w12.bias"] = w(2 * hs)
            sd[f"{pre}.mlp.w3.weight"] = w(f, hs)
            sd[f"{pre}.mlp.w3.bias"] = w(f)
        else:
            sd[f"{pre}.mlp.fc1.weight"] = w(hidden, f)
            sd[f"{pre}.mlp.fc1.bias"] = w(hidden)
            sd[f"{pre}.mlp.fc2.weight"] = w(f, hidden)
            sd[f"{pre}.mlp.fc2.bias"] = w(f)

    # Neck conv weights use fan-in scaling so the synthetic fusion and head
    # chain has about unit gain; a flat 0.05 scale lets the 256-channel 3x3
    # convs amplify the fused map until the head's final ReLU clips most of
    # the depth output to zero.
    def cw(co, ci, k):
        return w(co, ci, k, k, scale=1.0 / math.sqrt(ci * k * k))

    for i, r in enumerate(reassembly):
        sd[f"depth_head.projects.{i}.weight"] = w(r, f, 1, 1)
        sd[f"depth_head.projects.{i}.bias"] = w(r)
        sd[f"depth_head.scratch.layer{i + 1}_rn.weight"] = cw(cf, r, 3)
    sd["depth_head.resize_layers.0.weight"] = w(reassembly[0], reassembly[0], 4, 4)
    sd["depth_head.resize_layers.0.bias"] = w(reassembly[0])
    sd["depth_head.resize_layers.1.weight"] = w(reassembly[1], reassembly[1], 2, 2)
    sd["depth_head.resize_layers.1.bias"] = w(reassembly[1])
    sd["depth_head.resize_layers.3.weight"] = w(reassembly[3], reassembly[3], 3, 3)
    sd["depth_head.resize_layers.3.bias"] = w(reassembly[3])

    for k in range(1, 5):
        pre = f"depth_head.scratch.refinenet{k}"
        for unit in (1, 2):
            for conv in (1, 2):
                sd[f"{pre}.resConfUnit{unit}.conv{conv}.weight"] = cw(cf, cf, 3)
                sd[f"{pre}.resConfUnit{unit}.conv{conv}.bias"] = w(cf)
        sd[f"{pre}.out_conv.weight"] = cw(cf, cf, 1)
        sd[f"{pre}.out_conv.bias"] = w(cf)

    ch = cf // 2
    sd["depth_head.scratch.output_conv1.weight"] = cw(ch, cf, 3)
    sd["depth_head.scratch.output_conv1.bias"] = w(ch)
    sd["depth_head.scratch.output_conv2.0.weight"] = cw(32, ch, 3)
    sd["depth_head.scratch.output_conv2.0.bias"] = w(32)
    sd["depth_head.scratch.output_conv2.2.weight"] = w(1, 32, 1, 1, scale=0.3 / math.sqrt(32))
    # positive final bias keeps synthetic depth mostly above the ReLU clip
    sd["depth_head.scratch.output_conv2.2.bias"] = np.float32(2.0) + w(1)
    return sd


def random_original_video_depth_anything_state_dict(config: dict, seed: int = 0) -> dict:
    """Original Video Depth Anything layout: the Depth-Anything state dict of
    ``config`` with its head under ``head.`` instead of ``depth_head.``, and
    one temporal motion module per entry of ``config["temporal_channels"]``
    under ``head.motion_modules.<i>.temporal_transformer`` (GroupNorm,
    ``proj_in``, ``temporal_attention_blocks`` attention blocks (default 2)
    with their LayerNorms and the computed sinusoidal ``pos_encoder.pe`` of
    ``num_frames`` (default 32) positions, a GEGLU feed-forward of 4C,
    ``proj_out``). The JAX package has no such model; the motion modules
    draw from their own stream of the seed. Linear weights take a fan-in
    scale, so each module keeps its map's magnitude."""
    from ..models.temporal import sinusoidal_encoding

    sd = {("head." + k[len("depth_head."):] if k.startswith("depth_head.") else k): v
          for k, v in random_original_depth_anything_state_dict(config, seed).items()}
    rng = np.random.default_rng((seed, 0x7E))
    frames = config.get("num_frames", 32)

    def w(*shape, scale=0.05):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    for i, c in enumerate(config["temporal_channels"]):
        pre = f"head.motion_modules.{i}.temporal_transformer"
        block = f"{pre}.transformer_blocks.0"
        fan = 1.0 / math.sqrt(c)
        sd[f"{pre}.norm.weight"], sd[f"{pre}.norm.bias"] = 1.0 + w(c), w(c)
        for name in ("proj_in", "proj_out"):
            sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = w(c, c, scale=fan), w(c)
        for j in range(config.get("temporal_attention_blocks", 2)):
            att = f"{block}.attention_blocks.{j}"
            for x in "qkv":
                sd[f"{att}.to_{x}.weight"] = w(c, c, scale=fan)
            sd[f"{att}.to_out.0.weight"], sd[f"{att}.to_out.0.bias"] = w(c, c, scale=fan), w(c)
            sd[f"{att}.pos_encoder.pe"] = sinusoidal_encoding(frames, c).numpy()[None]
            sd[f"{block}.norms.{j}.weight"], sd[f"{block}.norms.{j}.bias"] = 1.0 + w(c), w(c)
        sd[f"{block}.ff_norm.weight"], sd[f"{block}.ff_norm.bias"] = 1.0 + w(c), w(c)
        sd[f"{block}.ff.net.0.proj.weight"], sd[f"{block}.ff.net.0.proj.bias"] = w(8 * c, c, scale=fan), w(8 * c)
        sd[f"{block}.ff.net.2.weight"] = w(c, 4 * c, scale=1.0 / math.sqrt(4 * c))
        sd[f"{block}.ff.net.2.bias"] = w(c)
    return sd
