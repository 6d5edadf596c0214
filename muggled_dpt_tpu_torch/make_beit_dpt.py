"""MiDaS v3.1 BEiT model factories."""

from __future__ import annotations

import torch

from .checkpoints.beit import convert_state_dict, get_config_from_state_dict, random_original_state_dict
from .dpt import DPTModel, assemble_model
from .models.beit_family import BEiTDPT, family_spec


def make_beit_dpt_from_midas_v31_state_dict(
    state_dict: dict,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    strict_load: bool = True,
    dtype=torch.float32,
    device=None,
) -> tuple[dict, DPTModel]:
    """Build a BEiT DPT model from an original MiDaS v3.1 state dict.
    Returns (config_dict, model). strict_load is accepted for API parity:
    the conversion reads every key it needs."""
    config_dict = get_config_from_state_dict(state_dict, enable_cache, enable_optimizations)
    converted = convert_state_dict(state_dict, config_dict)
    return config_dict, assemble_model(BEiTDPT, config_dict, converted, family_spec(config_dict), dtype, device)


def make_beit_dpt(
    features_per_token: int = 1024,
    num_heads: int = 16,
    num_blocks: int = 24,
    reassembly_features_list=(256, 512, 1024, 1024),
    base_patch_grid_hw=(32, 32),
    fusion_channels: int = 256,
    patch_size_px: int = 16,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    dtype=torch.float32,
    seed: int = 0,
    device=None,
) -> DPTModel:
    """Build a randomly-initialized BEiT DPT from explicit hyperparameters,
    with the same weights as the JAX package's builder for the same seed.

    Standard configs:
      beit-large-512: F=1024 H=16 L=24 reassembly=(256,512,1024,1024) grid=32
      beit-large-384: the same with grid=24
      beit-base-384:  F=768  H=12 L=12 reassembly=(96,192,384,768) grid=24
    """
    config_dict = {
        "features_per_token": features_per_token,
        "num_blocks": num_blocks,
        "num_heads": num_heads,
        "reassembly_features_list": list(reassembly_features_list),
        "fusion_channels": fusion_channels,
        "patch_size_px": patch_size_px,
        "base_patch_grid_hw": tuple(base_patch_grid_hw),
        "enable_cache": enable_cache,
        "enable_optimizations": enable_optimizations,
    }
    sd = random_original_state_dict(config_dict, seed=seed)
    converted = convert_state_dict(sd, config_dict)
    return assemble_model(BEiTDPT, config_dict, converted, family_spec(config_dict), dtype, device)
