"""Video Depth Anything in the original checkpoint's layout
(github.com/DepthAnything/Video-Depth-Anything ``video_depth_anything/video_depth.py``):
Depth-Anything V2's keys and shapes (``weights/depth_anything_v2.py``) with the
DPT head under ``head.`` instead of ``depth_head.``, and four temporal motion
modules, one per entry of ``temporal_channels``, under
``head.motion_modules.<i>.temporal_transformer``: ``norm`` (GroupNorm),
``proj_in``, ``proj_out`` and ``transformer_blocks.0`` with
``temporal_attention_blocks`` attention blocks (``to_q``, ``to_k``, ``to_v``
without bias, ``to_out.0``; LayerNorms ``norms.<j>``) and a GEGLU
feed-forward (``ff_norm``, ``ff.net.0.proj`` C -> 8C, ``ff.net.2`` 4C -> C).

The linear weights take a fan-in scale, as the neck's convolutions do, so a
module keeps its map's magnitude. Each attention block's ``pos_encoder.pe``
buffer, (1, ``num_frames``, C), is the sinusoidal encoding the original
computes at construction: computed here too, not drawn."""

from __future__ import annotations

from ..reference.video_depth_anything import sinusoidal_pe
from . import conv_scale, depth_anything_v2, draw


def module_key(i: int) -> str:
    return f"head.motion_modules.{i}.temporal_transformer"


def pe_key(i: int, j: int) -> str:
    return f"{module_key(i)}.transformer_blocks.0.attention_blocks.{j}.pos_encoder.pe"


def layout(config: dict) -> list:
    """(key, shape, scale, shift) of every tensor the model reads but the ``pe`` buffers."""
    out = [(("head." + key[len("depth_head."):]) if key.startswith("depth_head.") else key, shape, scale, shift)
           for key, shape, scale, shift in depth_anything_v2.layout(config)]
    w = 0.05
    for i, c in enumerate(config["temporal_channels"]):
        pre = module_key(i)
        blk = f"{pre}.transformer_blocks.0"
        fan = conv_scale(c, 1)
        out += [(f"{pre}.norm.weight", (c,), w, 1.0), (f"{pre}.norm.bias", (c,), w, 0.0),
                (f"{pre}.proj_in.weight", (c, c), fan, 0.0), (f"{pre}.proj_in.bias", (c,), w, 0.0)]
        for j in range(config["temporal_attention_blocks"]):
            att = f"{blk}.attention_blocks.{j}"
            out += [(f"{blk}.norms.{j}.weight", (c,), w, 1.0), (f"{blk}.norms.{j}.bias", (c,), w, 0.0)]
            out += [(f"{att}.to_{x}.weight", (c, c), fan, 0.0) for x in "qkv"]
            out += [(f"{att}.to_out.0.weight", (c, c), fan, 0.0), (f"{att}.to_out.0.bias", (c,), w, 0.0)]
        h = config["temporal_ff_mult"] * c
        out += [(f"{blk}.ff_norm.weight", (c,), w, 1.0), (f"{blk}.ff_norm.bias", (c,), w, 0.0),
                (f"{blk}.ff.net.0.proj.weight", (2 * h, c), fan, 0.0), (f"{blk}.ff.net.0.proj.bias", (2 * h,), w, 0.0),
                (f"{blk}.ff.net.2.weight", (c, h), conv_scale(h, 1), 0.0), (f"{blk}.ff.net.2.bias", (c,), w, 0.0),
                (f"{pre}.proj_out.weight", (c, c), fan, 0.0), (f"{pre}.proj_out.bias", (c,), w, 0.0)]
    return out


def generate(config: dict, seed: int, device, dtype) -> dict:
    """The original-layout state dict of ``config``, made on ``device`` in ``dtype``."""
    out = draw(layout(config), seed, device, dtype)
    for i, c in enumerate(config["temporal_channels"]):
        for j in range(config["temporal_attention_blocks"]):
            out[pe_key(i, j)] = sinusoidal_pe(config["num_frames"], c, device)[None].to(dtype)
    return out
