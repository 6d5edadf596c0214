"""Auto-loading entry point: build a DPT model from an original checkpoint
file, sniffing the model family from its state-dict keys. Returns
(config_dict, DPTModel), as the JAX package's ``make_dpt_from_state_dict``.

Every family of the JAX package is ported: Depth-Anything V1 and V2 (ViT-Giant
and the metric head included), MiDaS v3.1 BEiT and MiDaS v3.1 SwinV2. Video
Depth Anything, which the JAX package lacks, loads here too: its temporal
modules (``head.motion_modules.*`` keys) set it apart from DA-V2."""

from __future__ import annotations

import functools
import os.path as osp

import torch

from .dpt import DPTModel, assemble_model, resolve_device

KNOWN_MODEL_TYPES = ("swinv2", "beit", "depthanythingv1", "depthanythingv2", "videodepthanything")


def make_dpt_from_state_dict(
    path_to_state_dict: str,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    strict_load: bool = True,
    model_type: str | None = None,
    dtype=torch.float32,
    device=None,
    conversion_cache: bool = False,
    unroll_blocks: bool | int = False,
):
    """Load an original .pt/.pth or .safetensors checkpoint (unchanged, as
    downloaded; see ``load_state_dict``) and build the matching DPT model on
    ``device`` in ``dtype``. ``device=None`` means the CUDA card and raises
    without one; pass ``device="cpu"`` for the CPU. Returns (config_dict, model).

    conversion_cache=True keeps the converted float32 state dict beside the
    checkpoint (``<name>.dpt_torch_cache.npz``, ``checkpoints/cache.py``) and
    builds from it while the checkpoint's size and mtime are unchanged. A
    miss converts once, writes the cache and builds from the same converted
    tensors; the cache holds them in float32, which every checkpoint dtype
    widens to exactly, so a hit and a miss give the same model.

    unroll_blocks is the JAX package's compile-time switch (``lax.scan`` or
    an unrolled encoder); the port runs its blocks eagerly, so it is
    accepted and ignored."""
    device = resolve_device(device)
    cached = None
    if conversion_cache:
        from .checkpoints.cache import load_converted, save_converted

        cached = load_converted(path_to_state_dict)
    if cached is None:
        model_type, config_dict, converted = _convert_original(path_to_state_dict, enable_cache, enable_optimizations,
                                                               model_type)
        if conversion_cache:
            save_converted(path_to_state_dict, model_type, config_dict, converted)
    else:
        model_type, config_dict, converted = cached
        config_dict = dict(config_dict, enable_cache=enable_cache, enable_optimizations=enable_optimizations)
    return config_dict, _assemble_converted(model_type, config_dict, converted, dtype, device)


def _convert_original(path_to_state_dict, enable_cache, enable_optimizations, model_type):
    """(model_type, config_dict, converted state dict) from the original
    checkpoint: the family sniffed from its keys unless given, then the
    family's config and key conversion (no model is built)."""
    state_dict = load_state_dict(path_to_state_dict)

    if model_type is None:
        model_type = determine_model_type_from_state_dict(path_to_state_dict, state_dict)
    if model_type not in KNOWN_MODEL_TYPES:
        print("Accepted model types:", *KNOWN_MODEL_TYPES, sep="\n")
        raise NotImplementedError(f"Bad model type: {model_type}, no support for this yet!")

    if model_type == "swinv2":
        from .checkpoints import swinv2 as family
    elif model_type == "beit":
        from .checkpoints import beit as family
    elif model_type == "videodepthanything":
        from .checkpoints import video_depth_anything as family
    else:
        from .checkpoints import depth_anything as family

        # Metric-model hack: metric DA-V2 weights are indistinguishable from
        # relative ones, so the file name flags them.
        if model_type == "depthanythingv2" and "metric" in path_to_state_dict:
            state_dict["is_metric"] = torch.zeros(())
            print(
                "",
                "Warning: Metric Depth-Anything V2 model detected!",
                "  These models are not officially supported,",
                "  model outputs may be incorrect...",
                sep="\n",
                flush=True,
            )
    config_dict = family.get_config_from_state_dict(state_dict, enable_cache, enable_optimizations)
    if model_type == "depthanythingv1":  # no ViT-Giant (SwiGLU) or metric V1
        config_dict.update(is_giant=False, is_metric=False)
    return model_type, config_dict, family.convert_state_dict(state_dict, config_dict)


def _assemble_converted(model_type: str, config_dict: dict, state_dict: dict, dtype, device) -> DPTModel:
    """A model of ``model_type`` from a converted state dict (the
    counterpart of JAX ``make_dpt.py:_build_from_converted``)."""
    if model_type in ("depthanythingv1", "depthanythingv2"):
        from .make_depthanythingv2_dpt import family_spec
        from .models.depth_anything import DepthAnything

        net_cls = functools.partial(DepthAnything, version=1 if model_type == "depthanythingv1" else 2)
    elif model_type == "beit":
        from .models.beit_family import BEiTDPT as net_cls, family_spec
    elif model_type == "videodepthanything":
        from .models.video_depth_anything import VideoDepthAnything as net_cls, family_spec
    else:
        from .models.swinv2_family import SwinV2DPT as net_cls, family_spec
    return assemble_model(net_cls, config_dict, state_dict, family_spec(config_dict), dtype, device)


def load_state_dict(path: str) -> dict:
    """A checkpoint as a flat {name: tensor} state dict: a .safetensors file
    through safetensors, anything else through ``torch.load``; a single
    ``{"state_dict": ...}`` or ``{"model": ...}`` container is unwrapped
    when no value beside it is a tensor. The JAX package's
    ``checkpoints/pt_loader.py:load_state_dict`` (its copy, since that
    module belongs to the JAX package)."""
    if str(path).lower().endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for wrapper in ("state_dict", "model"):
            inner = obj.get(wrapper)
            if isinstance(inner, dict) and inner and not any(isinstance(v, torch.Tensor) for v in obj.values()):
                obj = inner
                break
    if not isinstance(obj, dict):
        raise ValueError(f"Checkpoint at {path} did not contain a state dict")
    return obj


def determine_model_type_from_state_dict(model_path: str, state_dict: dict) -> str:
    """Key-sniffing family detection."""
    keys = state_dict.keys()
    if "pretrained.model.layers.0.blocks.0.attn.logit_scale" in keys:
        return "swinv2"
    if "pretrained.model.blocks.0.attn.relative_position_bias_table" in keys:
        return "beit"
    if any(k.startswith("head.motion_modules.") for k in keys):
        return "videodepthanything"
    if "pretrained.blocks.0.ls1.gamma" in keys:
        model_name = osp.basename(model_path).lower()
        is_v2 = "v2" in model_name
        is_v1 = (not is_v2) and (("anything_vit" in model_name) or ("v1" in model_name))
        if (not is_v1) and (not is_v2):
            print(
                "",
                "WARNING: Unable to determine DepthAnything model version!",
                "-> Will assume v2",
                "-> Will use v1 if the file name contains 'v1'",
                sep="\n",
            )
        return "depthanythingv1" if is_v1 else "depthanythingv2"
    return "unknown"
