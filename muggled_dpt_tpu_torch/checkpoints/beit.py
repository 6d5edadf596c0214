"""MiDaS v3.1 BEiT checkpoint conversion: original ``.pt`` state dicts
(unchanged, as downloaded) -> (config dict, this package's state dict), and
a synthetic original-format state dict from numpy alone.

Config inference and key routing follow the JAX package's
``muggled_dpt_tpu/checkpoints/beit.py``. The port keeps torch's own layouts;
the tensor surgery is the head-major qkv reorder, the fused qkv bias
(q_bias | zero k | v_bias, head-major), the per-block relative-position LUTs
stacked into one (L, R, H) tensor, and dropping the stored
``relative_position_index`` buffers, which the model rebuilds."""

from __future__ import annotations

import math

import numpy as np
import torch

from .convert_common import max_index, qkv_bias, qkv_head_major, qkv_vec_head_major, t_tensor

REASSEMBLY_SCALES = (4, 2, 1, 0.5)


def get_config_from_state_dict(state_dict: dict, enable_cache=True, enable_optimizations=True) -> dict:
    """Infer hyperparameters from shapes: the base grid from the LUT length
    R = (2g-1)^2 + 3, the heads from the LUT width."""
    pe = state_dict["pretrained.model.patch_embed.proj.weight"]  # (F, 3, P, P)
    lut = state_dict["pretrained.model.blocks.0.attn.relative_position_bias_table"]  # (R, H)
    num_blocks = max_index(state_dict, "pretrained.model.blocks") + 1
    if num_blocks <= 1:
        raise ValueError("Could not find transformer blocks in state dict")
    num_rel = int(lut.shape[0]) - 3
    side = math.isqrt(num_rel)
    if side * side != num_rel or side % 2 != 1:
        raise ValueError(f"relpos LUT length {int(lut.shape[0])} is not (2g-1)^2 + 3")
    base_grid = (side + 1) // 2
    reassembly = [int(state_dict[f"scratch.layer{i}_rn.weight"].shape[1]) for i in range(1, 5)]
    return {
        "features_per_token": int(pe.shape[0]),
        "num_blocks": int(num_blocks),
        "num_heads": int(lut.shape[1]),
        "reassembly_features_list": reassembly,
        "fusion_channels": int(state_dict["scratch.layer1_rn.weight"].shape[0]),
        "patch_size_px": int(pe.shape[-1]),
        "base_patch_grid_hw": (base_grid, base_grid),
        "enable_cache": enable_cache,
        "enable_optimizations": enable_optimizations,
    }


def qkv_bias_head_major(q_bias: torch.Tensor, v_bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The fused qkv bias (``qkv_bias``) in head-major [head][q|k|v][dim] order."""
    return qkv_vec_head_major(qkv_bias(q_bias, v_bias), num_heads)


def _convert_encoder(sd: dict, cfg: dict) -> dict:
    heads = cfg["num_heads"]
    out = {"encoder.cls_token": t_tensor(sd["pretrained.model.cls_token"])}
    luts = []
    for i in range(cfg["num_blocks"]):
        src, dst = f"pretrained.model.blocks.{i}", f"encoder.blocks.{i}"
        out[f"{dst}.attn.qkv.weight"] = qkv_head_major(t_tensor(sd[f"{src}.attn.qkv.weight"]), heads)
        out[f"{dst}.attn.qkv.bias"] = qkv_bias_head_major(
            t_tensor(sd[f"{src}.attn.q_bias"]), t_tensor(sd[f"{src}.attn.v_bias"]), heads
        )
        out[f"{dst}.ls1"] = t_tensor(sd[f"{src}.gamma_1"])
        out[f"{dst}.ls2"] = t_tensor(sd[f"{src}.gamma_2"])
        for name in ("norm1", "norm2", "attn.proj", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{name}.{leaf}"] = t_tensor(sd[f"{src}.{name}.{leaf}"])
        luts.append(t_tensor(sd[f"{src}.attn.relative_position_bias_table"]))
        # the stored relative_position_index buffer is deterministic: dropped
    out["encoder.relpos_lut"] = torch.stack(luts)
    return out


def _convert_reassembly(sd: dict) -> dict:
    out = {}
    for s in range(1, 5):
        src, dst = f"pretrained.act_postprocess{s}", f"reassemble.{s - 1}"
        for leaf in ("weight", "bias"):
            out[f"{dst}.readout.{leaf}"] = t_tensor(sd[f"{src}.0.project.0.{leaf}"])
            out[f"{dst}.proj.{leaf}"] = t_tensor(sd[f"{src}.3.{leaf}"])
            if f"{src}.4.{leaf}" in sd:  # stage 3 (no scaling) has no resample layer
                out[f"{dst}.resample.{leaf}"] = t_tensor(sd[f"{src}.4.{leaf}"])
        out[f"{dst}.fuse.weight"] = t_tensor(sd[f"scratch.layer{s}_rn.weight"])
    return out


def _convert_fusion(sd: dict) -> dict:
    """refinenet{k} -> fusion.{k-1}; refinenet4.resConfUnit1 is unused."""
    out = {}
    for k in range(1, 5):
        src, dst = f"scratch.refinenet{k}", f"fusion.{k - 1}"
        units = (1, 2) if k != 4 else (2,)
        for leaf in ("weight", "bias"):
            for u in units:
                for conv in ("conv1", "conv2"):
                    out[f"{dst}.res{u}.{conv}.{leaf}"] = t_tensor(sd[f"{src}.resConfUnit{u}.{conv}.{leaf}"])
            out[f"{dst}.out.{leaf}"] = t_tensor(sd[f"{src}.out_conv.{leaf}"])
    return out


def _convert_head(sd: dict) -> dict:
    names = {"conv_in": "output_conv.0", "conv_mid": "output_conv.2", "proj": "output_conv.4"}
    return {
        f"head.{dst}.{leaf}": t_tensor(sd[f"scratch.{orig}.{leaf}"])
        for dst, orig in names.items()
        for leaf in ("weight", "bias")
    }


def convert_state_dict(state_dict: dict, cfg: dict) -> dict:
    """Original MiDaS v3.1 BEiT state dict (numpy arrays or tensors) -> this
    package's BEiT DPT state dict (float32 CPU tensors)."""
    sd = state_dict
    return {
        "patch_embed.weight": t_tensor(sd["pretrained.model.patch_embed.proj.weight"]),
        "patch_embed.bias": t_tensor(sd["pretrained.model.patch_embed.proj.bias"]),
        **_convert_encoder(sd, cfg),
        **_convert_reassembly(sd),
        **_convert_fusion(sd),
        **_convert_head(sd),
    }


def random_original_state_dict(config: dict, seed: int = 0) -> dict:
    """Synthetic MiDaS-BEiT-format state dict (original torch keys and
    shapes) as numpy arrays. The draws are the JAX package's
    (``muggled_dpt_tpu/checkpoints/beit.py:random_original_state_dict``), so
    one seed gives a byte-identical state dict in both packages."""
    rng = np.random.default_rng(seed)
    f = config["features_per_token"]
    p = config["patch_size_px"]
    g = config["base_patch_grid_hw"][0]
    heads = config["num_heads"]
    n_blocks = config["num_blocks"]
    reassembly = config["reassembly_features_list"]
    cf = config["fusion_channels"]
    lut_len = (2 * g - 1) ** 2 + 3

    def w(*shape, scale=0.05):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    sd = {
        "pretrained.model.cls_token": w(1, 1, f),
        "pretrained.model.patch_embed.proj.weight": w(f, 3, p, p),
        "pretrained.model.patch_embed.proj.bias": w(f),
    }
    hidden = int(round(4.0 * f))
    for i in range(n_blocks):
        pre = f"pretrained.model.blocks.{i}"
        sd[f"{pre}.norm1.weight"] = 1.0 + w(f)
        sd[f"{pre}.norm1.bias"] = w(f)
        sd[f"{pre}.attn.qkv.weight"] = w(3 * f, f)
        sd[f"{pre}.attn.q_bias"] = w(f)
        sd[f"{pre}.attn.v_bias"] = w(f)
        sd[f"{pre}.attn.proj.weight"] = w(f, f)
        sd[f"{pre}.attn.proj.bias"] = w(f)
        sd[f"{pre}.attn.relative_position_bias_table"] = w(lut_len, heads, scale=0.2)
        sd[f"{pre}.attn.relative_position_index"] = np.zeros((g * g + 1, g * g + 1), dtype=np.int64)
        sd[f"{pre}.gamma_1"] = 1.0 + w(f)
        sd[f"{pre}.gamma_2"] = 1.0 + w(f)
        sd[f"{pre}.norm2.weight"] = 1.0 + w(f)
        sd[f"{pre}.norm2.bias"] = w(f)
        sd[f"{pre}.mlp.fc1.weight"] = w(hidden, f)
        sd[f"{pre}.mlp.fc1.bias"] = w(hidden)
        sd[f"{pre}.mlp.fc2.weight"] = w(f, hidden)
        sd[f"{pre}.mlp.fc2.bias"] = w(f)

    # Neck conv weights use fan-in scaling so the synthetic fusion and head
    # chain has about unit gain (see checkpoints/random_init.py).
    def cw(co, ci, k):
        return w(co, ci, k, k, scale=1.0 / math.sqrt(ci * k * k))

    for s, r in zip(range(1, 5), reassembly):
        pre = f"pretrained.act_postprocess{s}"
        sd[f"{pre}.0.project.0.weight"] = w(f, 2 * f, scale=1.0 / math.sqrt(2 * f))
        sd[f"{pre}.0.project.0.bias"] = w(f)
        sd[f"{pre}.3.weight"] = cw(r, f, 1)
        sd[f"{pre}.3.bias"] = w(r)
        sd[f"scratch.layer{s}_rn.weight"] = cw(cf, r, 3)
    sd["pretrained.act_postprocess1.4.weight"] = cw(reassembly[0], reassembly[0], 4)
    sd["pretrained.act_postprocess1.4.bias"] = w(reassembly[0])
    sd["pretrained.act_postprocess2.4.weight"] = cw(reassembly[1], reassembly[1], 2)
    sd["pretrained.act_postprocess2.4.bias"] = w(reassembly[1])
    sd["pretrained.act_postprocess4.4.weight"] = cw(reassembly[3], reassembly[3], 3)
    sd["pretrained.act_postprocess4.4.bias"] = w(reassembly[3])

    for k in range(1, 5):
        pre = f"scratch.refinenet{k}"
        for unit in (1, 2):
            for conv in (1, 2):
                sd[f"{pre}.resConfUnit{unit}.conv{conv}.weight"] = cw(cf, cf, 3)
                sd[f"{pre}.resConfUnit{unit}.conv{conv}.bias"] = w(cf)
        sd[f"{pre}.out_conv.weight"] = cw(cf, cf, 1)
        sd[f"{pre}.out_conv.bias"] = w(cf)

    ch = cf // 2
    sd["scratch.output_conv.0.weight"] = cw(ch, cf, 3)
    sd["scratch.output_conv.0.bias"] = w(ch)
    sd["scratch.output_conv.2.weight"] = cw(32, ch, 3)
    sd["scratch.output_conv.2.bias"] = w(32)
    sd["scratch.output_conv.4.weight"] = w(1, 32, 1, 1, scale=0.3 / math.sqrt(32))
    # positive final bias keeps synthetic depth mostly above the ReLU clip
    sd["scratch.output_conv.4.bias"] = np.float32(2.0) + w(1)
    return sd
