"""Depth-Anything V2 checkpoint conversion: original ``.pth`` state dicts
(unchanged, as downloaded) -> (config dict, this package's state dict).

Config inference and key routing follow the JAX package's
``muggled_dpt_tpu/checkpoints/depth_anything.py``. The port keeps torch's own
layouts, so the only tensor surgery is the pos-embed split into cls and patch
parts and the head-major qkv reorder."""

from __future__ import annotations

import math

from .convert_common import max_index, qkv_head_major, qkv_vec_head_major, t_tensor

REASSEMBLY_SCALES = (4, 2, 1, 0.5)


def get_config_from_state_dict(state_dict: dict, enable_cache=True, enable_optimizations=True) -> dict:
    """Infer model hyperparameters purely from tensor shapes and keys."""
    pe = state_dict["pretrained.patch_embed.proj.weight"]  # (F, 3, P, P)
    features = int(pe.shape[0])
    patch_px = int(pe.shape[-1])

    num_blocks = max_index(state_dict, "pretrained.blocks") + 1
    if num_blocks <= 1:
        raise ValueError("Could not find transformer blocks in state dict")

    reassembly = [int(state_dict[f"depth_head.scratch.layer{i}_rn.weight"].shape[1]) for i in range(1, 5)]
    fusion_channels = int(state_dict["depth_head.scratch.layer1_rn.weight"].shape[0])

    num_pos_tokens = int(state_dict["pretrained.pos_embed"].shape[1])
    base_grid = int(math.isqrt(num_pos_tokens - 1))

    return {
        "features_per_token": features,
        "num_blocks": int(num_blocks),
        # heads aren't recoverable from weights; F/64 holds for all released sizes
        "num_heads": features // 64,
        "reassembly_features_list": reassembly,
        "fusion_channels": fusion_channels,
        "patch_size_px": patch_px,
        "base_patch_grid_hw": (base_grid, base_grid),
        "is_giant": "pretrained.blocks.0.mlp.w12.weight" in state_dict,
        "is_metric": "is_metric" in state_dict,
        "enable_cache": enable_cache,
        "enable_optimizations": enable_optimizations,
    }


def _convert_encoder(sd: dict, cfg: dict) -> dict:
    if cfg["is_giant"]:
        raise NotImplementedError("SwiGLU (ViT-Giant) blocks are not ported yet: ROADMAP Queue A item 7")
    heads = cfg["num_heads"]
    pos_embed = t_tensor(sd["pretrained.pos_embed"])  # (1, 1+N, F)
    out = {
        "encoder.cls_token": t_tensor(sd["pretrained.cls_token"]),
        # split the single pos_embed into cls and patch parts
        "encoder.cls_embed": pos_embed[:, :1, :].contiguous(),
        "encoder.pos_embed": pos_embed[:, 1:, :].contiguous(),
        "encoder.outnorm.weight": t_tensor(sd["pretrained.norm.weight"]),
        "encoder.outnorm.bias": t_tensor(sd["pretrained.norm.bias"]),
    }
    for i in range(cfg["num_blocks"]):
        src, dst = f"pretrained.blocks.{i}", f"encoder.blocks.{i}"
        out[f"{dst}.attn.qkv.weight"] = qkv_head_major(t_tensor(sd[f"{src}.attn.qkv.weight"]), heads)
        out[f"{dst}.attn.qkv.bias"] = qkv_vec_head_major(t_tensor(sd[f"{src}.attn.qkv.bias"]), heads)
        out[f"{dst}.ls1"] = t_tensor(sd[f"{src}.ls1.gamma"])
        out[f"{dst}.ls2"] = t_tensor(sd[f"{src}.ls2.gamma"])
        for name in ("norm1", "norm2", "attn.proj", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{name}.{leaf}"] = t_tensor(sd[f"{src}.{name}.{leaf}"])
    return out


def _convert_reassembly(sd: dict) -> dict:
    out = {}
    for i in range(4):
        for leaf in ("weight", "bias"):
            out[f"reassemble.{i}.proj.{leaf}"] = t_tensor(sd[f"depth_head.projects.{i}.{leaf}"])
            # stage 2 (no scaling) has no resize layer
            if f"depth_head.resize_layers.{i}.{leaf}" in sd:
                out[f"reassemble.{i}.resample.{leaf}"] = t_tensor(sd[f"depth_head.resize_layers.{i}.{leaf}"])
        out[f"reassemble.{i}.fuse.weight"] = t_tensor(sd[f"depth_head.scratch.layer{i + 1}_rn.weight"])
    return out


def _convert_fusion(sd: dict) -> dict:
    """refinenet{k} -> fusion.{k-1}; refinenet4.resConfUnit1 is unused and
    discarded (the top-most block has no reassembly input)."""
    out = {}
    for k in range(1, 5):
        src, dst = f"depth_head.scratch.refinenet{k}", f"fusion.{k - 1}"
        units = (1, 2) if k != 4 else (2,)
        for leaf in ("weight", "bias"):
            for u in units:
                for conv in ("conv1", "conv2"):
                    out[f"{dst}.res{u}.{conv}.{leaf}"] = t_tensor(sd[f"{src}.resConfUnit{u}.{conv}.{leaf}"])
            out[f"{dst}.out.{leaf}"] = t_tensor(sd[f"{src}.out_conv.{leaf}"])
    return out


def _convert_head(sd: dict) -> dict:
    src = "depth_head.scratch"
    names = {"conv_in": "output_conv1", "conv_mid": "output_conv2.0", "proj": "output_conv2.2"}
    return {
        f"head.{dst}.{leaf}": t_tensor(sd[f"{src}.{orig}.{leaf}"])
        for dst, orig in names.items()
        for leaf in ("weight", "bias")
    }


def convert_state_dict(state_dict: dict, cfg: dict) -> dict:
    """Original Depth-Anything state dict (numpy arrays or tensors) -> this
    package's DepthAnything state dict (float32 CPU tensors)."""
    sd = state_dict
    return {
        "patch_embed.weight": t_tensor(sd["pretrained.patch_embed.proj.weight"]),
        "patch_embed.bias": t_tensor(sd["pretrained.patch_embed.proj.bias"]),
        **_convert_encoder(sd, cfg),
        **_convert_reassembly(sd),
        **_convert_fusion(sd),
        **_convert_head(sd),
    }
