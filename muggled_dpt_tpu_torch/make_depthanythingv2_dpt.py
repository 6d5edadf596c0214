"""Depth-Anything V2 model factories."""

from __future__ import annotations

import torch

from .checkpoints.depth_anything import convert_state_dict, get_config_from_state_dict
from .dpt import DPTModel, assemble_model
from .models.depth_anything import MEAN_RGB, STD_RGB, DepthAnything


def family_spec(config_dict: dict) -> dict:
    patch_px = config_dict["patch_size_px"]
    return {
        "mean_rgb": MEAN_RGB,
        "std_rgb": STD_RGB,
        "patch_size_px": patch_px,
        "tiling_size": 2 * patch_px,
        "default_size_px": config_dict["base_patch_grid_hw"][0] * patch_px,
    }


def make_depthanythingv2_dpt_from_original_state_dict(
    state_dict: dict,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    strict_load: bool = True,
    dtype=torch.float32,
    device=None,
) -> tuple[dict, DPTModel]:
    """Build a DA-V2 DPT model from an original (unconverted) state dict.
    Returns (config_dict, model). enable_cache and strict_load are accepted
    for API parity: this family has no per-grid cache, and the conversion
    reads every key it needs."""
    config_dict = get_config_from_state_dict(state_dict, enable_cache, enable_optimizations)
    converted = convert_state_dict(state_dict, config_dict)
    return config_dict, assemble_model(DepthAnything, config_dict, converted, family_spec(config_dict), dtype, device)


def make_depthanythingv2_dpt(
    features_per_token: int,
    num_heads: int,
    num_blocks: int,
    reassembly_features_list,
    base_patch_grid_hw,
    fusion_channels: int = 256,
    patch_size_px: int = 14,
    is_metric: bool = False,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    dtype=torch.float32,
    device=None,
    seed: int = 0,
) -> DPTModel:
    """Build a randomly-initialized DA-V2 model from explicit hyperparameters,
    with the same weights as the JAX package's builder for the same seed.

    Standard configs:
      vit-small: F=384,  H=6,  L=12, reassembly=[48,96,192,384],   fusion=64
      vit-base:  F=768,  H=12, L=12, reassembly=[96,192,384,768],  fusion=128
      vit-large: F=1024, H=16, L=24, reassembly=[256,512,1024,1024], fusion=256
    """
    from .checkpoints.random_init import random_original_depth_anything_state_dict

    config_dict = {
        "features_per_token": features_per_token,
        "num_blocks": num_blocks,
        "num_heads": num_heads,
        "reassembly_features_list": list(reassembly_features_list),
        "fusion_channels": fusion_channels,
        "patch_size_px": patch_size_px,
        "base_patch_grid_hw": tuple(base_patch_grid_hw),
        "is_giant": False,
        "is_metric": is_metric,
        "enable_cache": enable_cache,
        "enable_optimizations": enable_optimizations,
    }
    sd = random_original_depth_anything_state_dict(config_dict, seed=seed)
    converted = convert_state_dict(sd, config_dict)
    return assemble_model(DepthAnything, config_dict, converted, family_spec(config_dict), dtype, device)
