"""MiDaS v3.1 SwinV2 checkpoint conversion: original ``.pt`` state dicts
(unchanged, as downloaded) -> (config dict, this package's state dict), and
a synthetic original-format state dict from numpy alone.

Config inference and key routing follow the JAX package's
``muggled_dpt_tpu/checkpoints/swinv2.py``: heads per stage from the
logit-scale shapes, layers per stage from the largest block index, window
size and base grid from the first stored ``attn_mask`` ((nW, A, A): window
sqrt(A), grid sqrt(nW * A)), the pretrained window sizes from a LUT. The
port keeps torch's own layouts and one entry per block; the tensor surgery
is the fused qkv bias (q_bias | zero k | v_bias, in torch's [q|k|v] order),
the logit scale's clamp and exp folded at load (exp(min(ls, log 100))), and
dropping the ``attn_mask``, ``relative_coords_table`` and
``relative_position_index`` buffers, which the model rebuilds per grid."""

from __future__ import annotations

import math

import numpy as np
import torch

from .beit import _convert_fusion, _convert_head  # the same scratch.* layout as BEiT
from .convert_common import qkv_bias, t_tensor

PRETRAINED_WINDOW_LUT = {16: (16, 16, 16, 8), 24: (12, 12, 12, 6)}


def get_config_from_state_dict(state_dict: dict, enable_cache=True, enable_optimizations=True) -> dict:
    heads, layers = {}, {}
    for key in state_dict:
        if not key.startswith("pretrained.model.layers."):
            continue
        parts = key.split(".")
        s = int(parts[3])
        if key.endswith("logit_scale"):
            heads[s] = int(state_dict[key].shape[0])
        if parts[4] == "blocks":
            layers[s] = max(layers.get(s, 0), int(parts[5]) + 1)
    heads_per_stage = [heads[s] for s in sorted(heads)]
    layers_per_stage = [layers[s] for s in sorted(layers)]
    if len(heads_per_stage) != 4:
        raise ValueError(f"Expecting 4 swinv2 stages, got {len(heads_per_stage)}")

    # window size and base grid from the first stored attn_mask, (nW, A, A)
    mask_key = next(k for k in sorted(state_dict) if k.endswith("attn_mask"))
    num_windows, window_area = (int(s) for s in state_dict[mask_key].shape[0:2])
    win = math.isqrt(window_area)
    base_grid = math.isqrt(num_windows * window_area)

    pe = state_dict["pretrained.model.patch_embed.proj.weight"]  # (F, 3, P, P)
    f0 = int(pe.shape[0])
    return {
        "features_per_stage": [f0, 2 * f0, 4 * f0, 8 * f0],
        "heads_per_stage": heads_per_stage,
        "layers_per_stage": layers_per_stage,
        "base_patch_grid_hw": (base_grid, base_grid),
        "window_size_hw": (win, win),
        "pretrained_window_sizes_per_stage": list(PRETRAINED_WINDOW_LUT.get(win, (None,) * 4)),
        "fusion_channels": int(state_dict["scratch.layer1_rn.weight"].shape[0]),
        "patch_size_px": int(pe.shape[-1]),
        "enable_cache": enable_cache,
        "enable_optimizations": enable_optimizations,
    }


def fold_logit_scale(logit_scale) -> torch.Tensor:
    """The stored (H, 1, 1) log-scale (a numpy array or a tensor of any
    float type, on any device) -> the (H,) multiplier the attention uses,
    exp(min(ls, log 100)), computed in float32 numpy as the JAX converter
    does."""
    ls = t_tensor(logit_scale).numpy().reshape(-1)
    return t_tensor(np.exp(np.minimum(ls, math.log(100.0))))


def _convert_block(sd: dict, src: str, dst: str) -> dict:
    out = {
        f"{dst}.qkv.weight": t_tensor(sd[f"{src}.attn.qkv.weight"]),
        f"{dst}.qkv.bias": qkv_bias(t_tensor(sd[f"{src}.attn.q_bias"]), t_tensor(sd[f"{src}.attn.v_bias"])),
        f"{dst}.logit_scale": fold_logit_scale(sd[f"{src}.attn.logit_scale"]),
        f"{dst}.cpb0.weight": t_tensor(sd[f"{src}.attn.cpb_mlp.0.weight"]),
        f"{dst}.cpb0.bias": t_tensor(sd[f"{src}.attn.cpb_mlp.0.bias"]),
        f"{dst}.cpb1.weight": t_tensor(sd[f"{src}.attn.cpb_mlp.2.weight"]),
    }
    for name, orig in (("proj", "attn.proj"), ("norm1", "norm1"), ("norm2", "norm2"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{name}.{leaf}"] = t_tensor(sd[f"{src}.{orig}.{leaf}"])
    return out


def convert_state_dict(state_dict: dict, cfg: dict) -> dict:
    """Original MiDaS v3.1 SwinV2 state dict (numpy arrays or tensors) ->
    this package's SwinV2DPT state dict (float32 CPU tensors)."""
    sd = state_dict
    out = {
        "patch_embed.weight": t_tensor(sd["pretrained.model.patch_embed.proj.weight"]),
        "patch_embed.bias": t_tensor(sd["pretrained.model.patch_embed.proj.bias"]),
        "patch_norm.weight": t_tensor(sd["pretrained.model.patch_embed.norm.weight"]),
        "patch_norm.bias": t_tensor(sd["pretrained.model.patch_embed.norm.bias"]),
    }
    for s, n_layers in enumerate(cfg["layers_per_stage"]):
        for b in range(n_layers):
            out.update(_convert_block(sd, f"pretrained.model.layers.{s}.blocks.{b}", f"encoder.stages.{s}.{b}"))
    for s in range(3):
        src, dst = f"pretrained.model.layers.{s}.downsample", f"encoder.merges.{s}"
        out[f"{dst}.reduction.weight"] = t_tensor(sd[f"{src}.reduction.weight"])
        out[f"{dst}.norm.weight"] = t_tensor(sd[f"{src}.norm.weight"])
        out[f"{dst}.norm.bias"] = t_tensor(sd[f"{src}.norm.bias"])
    for i in range(1, 5):
        out[f"reassemble.{i - 1}.fuse.weight"] = t_tensor(sd[f"scratch.layer{i}_rn.weight"])
    out.update(_convert_fusion(sd))
    out.update(_convert_head(sd))
    return out


def random_original_state_dict(config: dict, seed: int = 0) -> dict:
    """Synthetic MiDaS-SwinV2-format state dict (original torch keys and
    shapes) as numpy arrays. The draws are the JAX package's
    (``muggled_dpt_tpu/checkpoints/swinv2.py:random_original_state_dict``),
    so one seed gives a byte-identical state dict in both packages."""
    rng = np.random.default_rng(seed)
    feats = config["features_per_stage"]
    heads = config["heads_per_stage"]
    layers = config["layers_per_stage"]
    p = config["patch_size_px"]
    g = config["base_patch_grid_hw"][0]
    win = config["window_size_hw"][0]
    cf = config["fusion_channels"]

    def w(*shape, scale=0.05):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    f0 = feats[0]
    sd = {
        "pretrained.model.patch_embed.proj.weight": w(f0, 3, p, p),
        "pretrained.model.patch_embed.proj.bias": w(f0),
        "pretrained.model.patch_embed.norm.weight": 1.0 + w(f0),
        "pretrained.model.patch_embed.norm.bias": w(f0),
    }
    for s in range(4):
        f, h = feats[s], heads[s]
        hidden = 4 * f
        for b in range(layers[s]):
            pre = f"pretrained.model.layers.{s}.blocks.{b}"
            sd[f"{pre}.attn.qkv.weight"] = w(3 * f, f)
            sd[f"{pre}.attn.q_bias"] = w(f)
            sd[f"{pre}.attn.v_bias"] = w(f)
            sd[f"{pre}.attn.proj.weight"] = w(f, f)
            sd[f"{pre}.attn.proj.bias"] = w(f)
            sd[f"{pre}.attn.logit_scale"] = np.log(10 * np.ones((h, 1, 1), dtype=np.float32)) + w(h, 1, 1)
            sd[f"{pre}.attn.cpb_mlp.0.weight"] = w(512, 2, scale=0.5)
            sd[f"{pre}.attn.cpb_mlp.0.bias"] = w(512)
            sd[f"{pre}.attn.cpb_mlp.2.weight"] = w(h, 512)
            sd[f"{pre}.norm1.weight"] = 1.0 + w(f)
            sd[f"{pre}.norm1.bias"] = w(f)
            sd[f"{pre}.norm2.weight"] = 1.0 + w(f)
            sd[f"{pre}.norm2.bias"] = w(f)
            sd[f"{pre}.mlp.fc1.weight"] = w(hidden, f)
            sd[f"{pre}.mlp.fc1.bias"] = w(hidden)
            sd[f"{pre}.mlp.fc2.weight"] = w(f, hidden)
            sd[f"{pre}.mlp.fc2.bias"] = w(f)
        if s < 3:
            pre = f"pretrained.model.layers.{s}.downsample"
            sd[f"{pre}.reduction.weight"] = w(feats[s + 1], 4 * f)
            sd[f"{pre}.norm.weight"] = 1.0 + w(feats[s + 1])
            sd[f"{pre}.norm.bias"] = w(feats[s + 1])

    # Neck conv weights use fan-in scaling so the synthetic fusion and head
    # chain has about unit gain (see checkpoints/random_init.py).
    def cw(co, ci, k):
        return w(co, ci, k, k, scale=1.0 / math.sqrt(ci * k * k))

    # the stored attn_mask buffer drives the window and base-grid inference
    area = win * win
    n_windows = (g // win) ** 2
    sd["pretrained.model.layers.0.blocks.1.attn_mask"] = np.zeros((n_windows, area, area), dtype=np.float32)

    for i, f in enumerate(feats, start=1):
        sd[f"scratch.layer{i}_rn.weight"] = cw(cf, f, 3)
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
