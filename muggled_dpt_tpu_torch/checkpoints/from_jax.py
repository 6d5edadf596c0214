"""Map the JAX package's converted parameter trees (Depth-Anything, BEiT,
SwinV2) onto this package's state dicts, so that both packages can be run on the
same weights.

The JAX trees (``muggled_dpt_tpu/checkpoints/{depth_anything,beit,swinv2}.py:convert_state_dict``)
stack the encoder blocks along a leading (L, ...) axis (SwinV2: per stage, in
pairs) and store linears as (in, out), convolutions as HWIO and transposed
convolutions as (kh, kw, in, out). Their qkv columns are in the order this
package's qkv rows are: head-major for DA and BEiT, torch's [q|k|v] for
SwinV2. Only numpy arrays cross the boundary: this module imports no jax.

A tree of the JAX package's int8 tier (``DPTModel.quantize_encoder_int8``)
carries its quantized leaves across to the port's ``QuantLinear`` /
``QuantConv3x3`` buffers: ``<name>_kernel_q8`` (in, out) becomes
``weight_q8`` (out, in), ``<name>_kernel_scale`` (1, out) ``weight_scale``
(out,), ``<name>_act_smooth`` ``act_smooth``, the shiftsum convolutions'
``<name>_kernel9_q8`` (ci, 9 co) ``weight_q8`` (9 co, ci), and the BEiT
readout's bare ``kernel_q8`` / ``kernel_scale`` likewise. Load such a state
dict into a port model quantized with the same options."""

from __future__ import annotations

import numpy as np
import torch

from .beit import qkv_bias_head_major
from .convert_common import qkv_bias


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _linear(k):
    return _t(np.asarray(k).T)  # (in, out) -> (out, in)


def _conv(k):
    return _t(np.asarray(k).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _conv_transpose(k):
    return _t(np.asarray(k).transpose(2, 3, 0, 1))  # (kh, kw, in, out) -> (in, out, kh, kw)


def _conv1x1(k):
    return _linear(k)[:, :, None, None]  # linear (in, out) -> (out, in, 1, 1)


def _q8(q):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(q, dtype=np.int8).T))  # (in, out) -> (out, in)


def _weights(p: dict, name: str, key: str, dense=_linear) -> dict:
    """The port's weight entries under ``key`` for the JAX leaves of
    ``name`` in ``p`` (``name`` "conv1" reads ``conv1_kernel``, "" the bare
    ``kernel``): the int8 buffers where ``p`` holds them, else ``dense`` of
    the kernel. Biases are not included."""
    pre = name + "_" if name else ""
    for kernel in ("kernel", "kernel9"):
        if pre + kernel + "_q8" in p:
            sd = {f"{key}.weight_q8": _q8(p[pre + kernel + "_q8"]),
                  f"{key}.weight_scale": _t(np.asarray(p[pre + kernel + "_scale"]).reshape(-1))}
            if pre + "act_smooth" in p:
                sd[f"{key}.act_smooth"] = _t(p[pre + "act_smooth"])
            return sd
    return {f"{key}.weight": dense(p[pre + "kernel"])}


def params_from_jax(params_np: dict) -> dict:
    """JAX Depth-Anything (V1 or V2, ViT-Giant included) parameter tree
    (numpy leaves) -> this package's DepthAnything state dict (float32 CPU
    tensors)."""
    p = params_np
    sd = {
        "patch_embed.weight": _conv(p["patch_embed"]["kernel"]),
        "patch_embed.bias": _t(p["patch_embed"]["bias"]),
    }

    enc = p["encoder"]
    for name in ("cls_token", "cls_embed", "pos_embed"):
        sd[f"encoder.{name}"] = _t(enc[name])
    sd["encoder.outnorm.weight"] = _t(enc["outnorm_scale"])
    sd["encoder.outnorm.bias"] = _t(enc["outnorm_bias"])
    blocks = enc["blocks"]
    for i in range(np.shape(blocks["ls1"])[0]):
        sd.update(_block(blocks, i))
        sd[f"encoder.blocks.{i}.attn.qkv.bias"] = _t(blocks["qkv_bias"][i])
    sd.update(_neck(p))
    return sd


def beit_params_from_jax(params_np: dict) -> dict:
    """JAX BEiT parameter tree (numpy leaves) -> this package's BEiTDPT state
    dict (float32 CPU tensors)."""
    p = params_np
    sd = {
        "patch_embed.weight": _conv(p["patch_embed"]["kernel"]),
        "patch_embed.bias": _t(p["patch_embed"]["bias"]),
    }
    enc = p["encoder"]
    sd["encoder.cls_token"] = _t(enc["cls_token"])
    blocks = enc["blocks"]
    sd["encoder.relpos_lut"] = _t(blocks["relpos_lut"])
    heads = np.shape(blocks["relpos_lut"])[-1]
    for i in range(np.shape(blocks["ls1"])[0]):
        sd.update(_block(blocks, i))
        q_bias, v_bias = _t(blocks["q_bias"][i]), _t(blocks["v_bias"][i])
        sd[f"encoder.blocks.{i}.attn.qkv.bias"] = qkv_bias_head_major(q_bias, v_bias, heads)
    sd.update(_neck(p))
    for i, stage in enumerate(p["reassemble"]):
        sd.update(_weights(stage["readout"], "", f"reassemble.{i}.readout"))
        sd[f"reassemble.{i}.readout.bias"] = _t(stage["readout"]["bias"])
    return sd


def swinv2_params_from_jax(params_np: dict) -> dict:
    """JAX SwinV2 parameter tree (numpy leaves) -> this package's SwinV2DPT
    state dict (float32 CPU tensors). The JAX tree stacks each stage's blocks
    as (no-shift, shift) pairs, {"b0": (P, ...), "b1": (P, ...)}: block 2i is
    pair i's b0 and block 2i+1 its b1."""
    p = params_np
    pe = p["patch_embed"]
    sd = {
        "patch_embed.weight": _conv(pe["kernel"]),
        "patch_embed.bias": _t(pe["bias"]),
        "patch_norm.weight": _t(pe["norm_scale"]),
        "patch_norm.bias": _t(pe["norm_bias"]),
    }
    for s, stage in enumerate(p["encoder"]["stages"]):
        for i in range(np.shape(stage["b0"]["logit_scale"])[0]):
            for side in (0, 1):
                bp = {k: v[i] for k, v in stage[f"b{side}"].items()}
                pre = f"encoder.stages.{s}.{2 * i + side}"
                sd[f"{pre}.qkv.weight"] = _linear(bp["qkv_kernel"])
                sd[f"{pre}.qkv.bias"] = qkv_bias(_t(bp["q_bias"]), _t(bp["v_bias"]))
                sd[f"{pre}.logit_scale"] = _t(bp["logit_scale"])
                sd[f"{pre}.cpb1.weight"] = _linear(bp["cpb1_kernel"])
                for name in ("proj", "cpb0", "fc1", "fc2"):
                    sd.update(_weights(bp, name, f"{pre}.{name}"))
                    sd[f"{pre}.{name}.bias"] = _t(bp[f"{name}_bias"])
                for norm in ("norm1", "norm2"):
                    sd[f"{pre}.{norm}.weight"] = _t(bp[f"{norm}_scale"])
                    sd[f"{pre}.{norm}.bias"] = _t(bp[f"{norm}_bias"])
    for s, merge in enumerate(p["encoder"]["merges"]):
        sd[f"encoder.merges.{s}.reduction.weight"] = _linear(merge["reduction_kernel"])
        sd[f"encoder.merges.{s}.norm.weight"] = _t(merge["norm_scale"])
        sd[f"encoder.merges.{s}.norm.bias"] = _t(merge["norm_bias"])
    for i, stage in enumerate(p["reassemble"]):
        sd[f"reassemble.{i}.fuse.weight"] = _conv(stage["fuse_kernel"])
    sd.update(_fusion_and_head(p))
    return sd


def _block(blocks: dict, i: int) -> dict:
    """Block i of a stacked JAX block tree, all but the qkv bias. A SwiGLU
    block (ViT-Giant) holds w12 and w3 where the others hold fc1 and fc2."""
    pre = f"encoder.blocks.{i}"
    sd = {}
    mlp = ("w12", "w3") if "w12_bias" in blocks else ("fc1", "fc2")
    linears = {"qkv": "attn.qkv", "proj": "attn.proj", **{name: f"mlp.{name}" for name in mlp}}
    layer = {k: v[i] for k, v in blocks.items()}
    for jax_name, name in linears.items():
        sd.update(_weights(layer, jax_name, f"{pre}.{name}"))
        if name != "attn.qkv":
            sd[f"{pre}.{name}.bias"] = _t(blocks[f"{jax_name}_bias"][i])
    for norm in ("norm1", "norm2"):
        sd[f"{pre}.{norm}.weight"] = _t(blocks[f"{norm}_scale"][i])
        sd[f"{pre}.{norm}.bias"] = _t(blocks[f"{norm}_bias"][i])
    sd[f"{pre}.ls1"] = _t(blocks["ls1"][i])
    sd[f"{pre}.ls2"] = _t(blocks["ls2"][i])
    return sd


def _neck(p: dict) -> dict:
    """Reassembly (without a readout projection), fusion and head."""
    sd = {}
    for i, stage in enumerate(p["reassemble"]):
        pre = f"reassemble.{i}"
        sd.update(_weights(stage, "proj", f"{pre}.proj", _conv1x1))
        sd[f"{pre}.proj.bias"] = _t(stage["proj_bias"])
        if "resample_kernel" in stage:
            rk = stage["resample_kernel"]
            sd[f"{pre}.resample.weight"] = _conv_transpose(rk) if i in (0, 1) else _conv(rk)
            sd[f"{pre}.resample.bias"] = _t(stage["resample_bias"])
        sd[f"{pre}.fuse.weight"] = _conv(stage["fuse_kernel"])
    sd.update(_fusion_and_head(p))
    return sd


def _fusion_and_head(p: dict) -> dict:
    sd = {}
    for i, block in enumerate(p["fusion"]):
        pre = f"fusion.{i}"
        for unit in ("res1", "res2"):
            if unit in block:
                for conv in ("conv1", "conv2"):
                    sd.update(_weights(block[unit], conv, f"{pre}.{unit}.{conv}", _conv))
                    sd[f"{pre}.{unit}.{conv}.bias"] = _t(block[unit][f"{conv}_bias"])
        sd.update(_weights(block, "out", f"{pre}.out", _conv1x1))
        sd[f"{pre}.out.bias"] = _t(block["out_bias"])

    head = p["head"]
    for name in ("conv_in", "conv_mid"):
        sd.update(_weights(head, name, f"head.{name}", _conv))
        sd[f"head.{name}.bias"] = _t(head[f"{name}_bias"])
    sd["head.proj.weight"] = _conv1x1(head["proj_kernel"])
    sd["head.proj.bias"] = _t(head["proj_bias"])
    return sd
