"""Video Depth Anything checkpoint conversion: original state dicts
(github.com/DepthAnything/Video-Depth-Anything, unchanged, as downloaded) ->
(config dict, this package's state dict).

The encoder keeps Depth-Anything V2's ``pretrained.*`` keys; the DPT head
sits under ``head.`` where DA-V2 has ``depth_head.``, with four temporal
modules under ``head.motion_modules.<i>.temporal_transformer``: ``norm``
(GroupNorm), ``proj_in``, ``proj_out`` and one transformer block,
``transformer_blocks.0``, of ``attention_blocks.<j>`` (``to_q``, ``to_k``,
``to_v`` without bias, ``to_out.0``, the ``pos_encoder.pe`` buffer of shape
(1, num_frames, C)) with their LayerNorms ``norms.<j>``, and a GEGLU
feed-forward ``ff.net.0.proj`` (C -> 8C), ``ff.net.2`` (4C -> C) after
``ff_norm``. Everything but the motion modules goes through the DA-V2
converter; the third and fourth stages' 3x3 fuse convs (``layer3_rn``,
``layer4_rn``) move to the fusion blocks that run them
(``models/video_depth_anything.py``); each block's q, k and v weights are
stacked into one; a missing ``pe`` buffer is computed."""

from __future__ import annotations

import torch

from ..models.temporal import sinusoidal_encoding
from ..models.video_depth_anything import TEMPORAL_MAPS, published_taps
from . import depth_anything
from .convert_common import max_index, t_tensor

MOTION = "head.motion_modules"
TEMPORAL_HEADS = 8  # num_attention_heads of every released model; not recoverable from the weights
NUM_FRAMES = 32  # temporal_max_len, where the checkpoint holds no pe buffer to read it from


def dpt_view(state_dict: dict) -> dict:
    """The keys DA-V2's converter reads: ``head.`` as ``depth_head.``, the motion modules left out."""
    return {("depth_head." + k[len("head."):] if k.startswith("head.") else k): v
            for k, v in state_dict.items() if not k.startswith(MOTION + ".")}


def _pe_key(i: int, j: int) -> str:
    return f"{MOTION}.{i}.temporal_transformer.transformer_blocks.0.attention_blocks.{j}.pos_encoder.pe"


def get_config_from_state_dict(state_dict: dict, enable_cache=True, enable_optimizations=True) -> dict:
    """Infer model hyperparameters from tensor shapes and keys."""
    config = depth_anything.get_config_from_state_dict(dpt_view(state_dict), enable_cache, enable_optimizations)
    modules = max_index(state_dict, MOTION) + 1
    if modules != 4:
        raise ValueError(f"expected 4 temporal motion modules under {MOTION}, found {modules}")
    src = f"{MOTION}.0.temporal_transformer"
    if max_index(state_dict, f"{src}.transformer_blocks") != 0:
        raise NotImplementedError("only one transformer block per temporal module (the released models')")
    pe = state_dict.get(_pe_key(0, 0))
    config.update(
        encoder_taps=list(published_taps(config["num_blocks"])),
        temporal_channels=[int(state_dict[f"{MOTION}.{i}.temporal_transformer.proj_in.weight"].shape[0])
                           for i in range(modules)],
        temporal_heads=TEMPORAL_HEADS,
        temporal_attention_blocks=max_index(state_dict, f"{src}.transformer_blocks.0.attention_blocks") + 1,
        num_frames=int(pe.shape[-2]) if pe is not None else NUM_FRAMES,
    )
    return config


def _convert_temporal(sd: dict, cfg: dict) -> dict:
    out = {}
    names = {"norm": "norm", "proj_in": "proj_in", "proj_out": "proj_out",
             "ff_norm": "transformer_blocks.0.ff_norm", "ff_in": "transformer_blocks.0.ff.net.0.proj",
             "ff_out": "transformer_blocks.0.ff.net.2"}
    for i, c in enumerate(cfg["temporal_channels"]):
        src, dst = f"{MOTION}.{i}.temporal_transformer", f"temporal.{i}"
        for name, orig in names.items():
            for leaf in ("weight", "bias"):
                out[f"{dst}.{name}.{leaf}"] = t_tensor(sd[f"{src}.{orig}.{leaf}"])
        for j in range(cfg["temporal_attention_blocks"]):
            att, block = f"{src}.transformer_blocks.0.attention_blocks.{j}", f"{dst}.attention.{j}"
            out[f"{block}.qkv.weight"] = torch.cat([t_tensor(sd[f"{att}.to_{x}.weight"]) for x in "qkv"])
            for leaf in ("weight", "bias"):
                out[f"{block}.out.{leaf}"] = t_tensor(sd[f"{att}.to_out.0.{leaf}"])
                out[f"{block}.norm.{leaf}"] = t_tensor(sd[f"{src}.transformer_blocks.0.norms.{j}.{leaf}"])
            pe = sd.get(_pe_key(i, j))
            out[f"{block}.pe"] = (sinusoidal_encoding(cfg["num_frames"], c) if pe is None
                                  else t_tensor(pe).reshape(cfg["num_frames"], c))
    return out


def convert_state_dict(state_dict: dict, cfg: dict) -> dict:
    """Original Video Depth Anything state dict (numpy arrays or tensors) ->
    this package's VideoDepthAnything state dict (float32 CPU tensors)."""
    out = depth_anything.convert_state_dict(dpt_view(state_dict), cfg)
    for i in TEMPORAL_MAPS:
        out[f"fusion.{i}.fuse.weight"] = out.pop(f"reassemble.{i}.fuse.weight")
    out.update(_convert_temporal(state_dict, cfg))
    return out
