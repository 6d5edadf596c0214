"""MiDaS v3.1 SwinV2 model factories."""

from __future__ import annotations

import torch

from .checkpoints.swinv2 import convert_state_dict, get_config_from_state_dict, random_original_state_dict
from .dpt import DPTModel, assemble_model
from .models.swinv2_family import SwinV2DPT, family_spec


def make_swinv2_dpt_from_midas_v31_state_dict(
    state_dict: dict,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    strict_load: bool = True,
    dtype=torch.float32,
    device=None,
) -> tuple[dict, DPTModel]:
    """Build a SwinV2 DPT model from an original MiDaS v3.1 state dict.
    Returns (config_dict, model). strict_load is accepted for API parity:
    the conversion reads every key it needs."""
    config_dict = get_config_from_state_dict(state_dict, enable_cache, enable_optimizations)
    converted = convert_state_dict(state_dict, config_dict)
    return config_dict, assemble_model(SwinV2DPT, config_dict, converted, family_spec(config_dict), dtype, device)


def make_swinv2_dpt(
    features_per_stage=(96, 192, 384, 768),
    heads_per_stage=(3, 6, 12, 24),
    layers_per_stage=(2, 2, 6, 2),
    base_patch_grid_hw=(64, 64),
    window_size_hw=(16, 16),
    pretrained_window_sizes_per_stage=(16, 16, 16, 8),
    fusion_channels: int = 256,
    patch_size_px: int = 4,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    dtype=torch.float32,
    seed: int = 0,
    device=None,
) -> DPTModel:
    """Build a randomly-initialized SwinV2 DPT from explicit hyperparameters,
    with the same weights as the JAX package's ``make_swinv2_dpt`` for the same seed.

    Standard configs:
      swin2-tiny-256:  F=(96,192,384,768)    H=(3,6,12,24)  L=(2,2,6,2)  win=16 grid=64
      swin2-base-384:  F=(128,256,512,1024)  H=(4,8,16,32)  L=(2,2,18,2) win=24 grid=96
      swin2-large-384: F=(192,384,768,1536)  H=(6,12,24,48) L=(2,2,18,2) win=24 grid=96
    """
    config_dict = {
        "features_per_stage": list(features_per_stage),
        "heads_per_stage": list(heads_per_stage),
        "layers_per_stage": list(layers_per_stage),
        "base_patch_grid_hw": tuple(base_patch_grid_hw),
        "window_size_hw": tuple(window_size_hw),
        "pretrained_window_sizes_per_stage": list(pretrained_window_sizes_per_stage),
        "fusion_channels": fusion_channels,
        "patch_size_px": patch_size_px,
        "enable_cache": enable_cache,
        "enable_optimizations": enable_optimizations,
    }
    sd = random_original_state_dict(config_dict, seed=seed)
    converted = convert_state_dict(sd, config_dict)
    return assemble_model(SwinV2DPT, config_dict, converted, family_spec(config_dict), dtype, device)
