"""Depth-Anything V1 model factories.

V1 shares the original checkpoint format with V2; its encoder taps the last
4 consecutive blocks instead of the end of each quarter, and it has no
ViT-Giant (SwiGLU) or metric variant, so both flags are forced off, as the
JAX package's ``make_depthanythingv1_dpt.py`` does."""

from __future__ import annotations

import torch

from .checkpoints.depth_anything import get_config_from_state_dict
from .dpt import DPTModel
from .make_depthanythingv2_dpt import build


def make_depthanythingv1_dpt_from_original_state_dict(
    state_dict: dict,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    strict_load: bool = True,
    dtype=torch.float32,
    device=None,
) -> tuple[dict, DPTModel]:
    """Build a DA-V1 DPT model from an original (unconverted) state dict on
    ``device`` (None: the CUDA card). Returns (config_dict, model).
    enable_cache and strict_load are accepted for API parity."""
    config_dict = get_config_from_state_dict(state_dict, enable_cache, enable_optimizations)
    config_dict.update(is_giant=False, is_metric=False)
    return config_dict, build(config_dict, state_dict, 1, dtype, device)


def make_depthanythingv1_dpt(
    features_per_token: int,
    num_heads: int,
    num_blocks: int,
    reassembly_features_list,
    base_patch_grid_hw,
    fusion_channels: int = 256,
    patch_size_px: int = 14,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    dtype=torch.float32,
    device=None,
    seed: int = 0,
) -> DPTModel:
    """Build a randomly-initialized DA-V1 model from explicit hyperparameters
    on ``device`` (None: the CUDA card), with the same weights as the JAX
    package's builder for the same seed.

    Standard configs: vit-small F=384 H=6 L=12 fusion=64; vit-base F=768
    H=12 L=12 fusion=128; vit-large F=1024 H=16 L=24 fusion=256; all patch
    14, base grid 37."""
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
        "is_metric": False,
        "enable_cache": enable_cache,
        "enable_optimizations": enable_optimizations,
    }
    return build(config_dict, random_original_depth_anything_state_dict(config_dict, seed=seed), 1, dtype, device)
