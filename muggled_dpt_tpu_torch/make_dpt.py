"""Auto-loading entry point: build a DPT model from an original checkpoint
file, sniffing the model family from its state-dict keys. Returns
(config_dict, DPTModel), as the JAX package's ``make_dpt_from_state_dict``.

Depth-Anything V2, MiDaS v3.1 BEiT and MiDaS v3.1 SwinV2 are ported so
far; Depth-Anything V1 raises ``NotImplementedError`` naming the ROADMAP item
that ports it."""

from __future__ import annotations

import os.path as osp

import torch

KNOWN_MODEL_TYPES = ("swinv2", "beit", "depthanythingv1", "depthanythingv2")
_NOT_PORTED = {
    "depthanythingv1": "ROADMAP Queue A item 7 (DA-V1, metric head and ViT-Giant)",
}


def make_dpt_from_state_dict(
    path_to_state_dict: str,
    enable_cache: bool = True,
    enable_optimizations: bool = True,
    strict_load: bool = True,
    model_type: str | None = None,
    dtype=torch.float32,
    device=None,
):
    """Load an original .pt/.pth checkpoint (unchanged, as downloaded) and
    build the matching DPT model on ``device`` in ``dtype``. Returns
    (config_dict, model)."""
    state_dict = torch.load(path_to_state_dict, map_location="cpu", weights_only=True)

    if model_type is None:
        model_type = determine_model_type_from_state_dict(path_to_state_dict, state_dict)
    if model_type not in KNOWN_MODEL_TYPES:
        print("Accepted model types:", *KNOWN_MODEL_TYPES, sep="\n")
        raise NotImplementedError(f"Bad model type: {model_type}, no support for this yet!")
    if model_type in _NOT_PORTED:
        raise NotImplementedError(f"{model_type} is not ported to muggled_dpt_tpu_torch yet: {_NOT_PORTED[model_type]}")

    if model_type == "swinv2":
        from .make_swinv2_dpt import make_swinv2_dpt_from_midas_v31_state_dict

        return make_swinv2_dpt_from_midas_v31_state_dict(
            state_dict, enable_cache, enable_optimizations, strict_load, dtype=dtype, device=device
        )
    if model_type == "beit":
        from .make_beit_dpt import make_beit_dpt_from_midas_v31_state_dict

        return make_beit_dpt_from_midas_v31_state_dict(
            state_dict, enable_cache, enable_optimizations, strict_load, dtype=dtype, device=device
        )

    # Metric-model hack: metric DA-V2 weights are indistinguishable from
    # relative ones, so the file name flags them.
    if "metric" in path_to_state_dict:
        state_dict["is_metric"] = torch.zeros(())
        print(
            "",
            "Warning: Metric Depth-Anything V2 model detected!",
            "  These models are not officially supported,",
            "  model outputs may be incorrect...",
            sep="\n",
            flush=True,
        )

    from .make_depthanythingv2_dpt import make_depthanythingv2_dpt_from_original_state_dict

    return make_depthanythingv2_dpt_from_original_state_dict(
        state_dict, enable_cache, enable_optimizations, strict_load, dtype=dtype, device=device
    )


def determine_model_type_from_state_dict(model_path: str, state_dict: dict) -> str:
    """Key-sniffing family detection."""
    keys = state_dict.keys()
    if "pretrained.model.layers.0.blocks.0.attn.logit_scale" in keys:
        return "swinv2"
    if "pretrained.model.blocks.0.attn.relative_position_bias_table" in keys:
        return "beit"
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
