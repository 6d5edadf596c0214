"""Core functional NN ops on torch tensors.

Layouts are torch's own: Linear weights (out, in), conv weights OIHW,
transposed-conv weights (in, out, kh, kw), feature maps NCHW, tokens
(B, N, C). The JAX package's counterparts (``muggled_dpt_tpu/ops/nn.py``)
hold the same math in TPU layouts."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.flash_attention import flash_attention_fused_qkv
from .kernels.flash_attention import flash_attention_reference as sdpa  # the plain attention path, JAX's name


def layer_norm(x, weight, bias, eps: float = 1e-6):
    """LayerNorm over the last axis. torch accumulates the statistics and the
    affine step in float32 for bfloat16 input and rounds once at the end, so
    no float32 copy of the tokens is needed."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def linear(x, weight, bias=None):
    return F.linear(x, weight, bias)


def gelu(x):
    """Exact (erf) GELU in every dtype, as torch's nn.GELU."""
    return F.gelu(x)


def mlp_gelu(x, fc1_weight, fc1_bias, fc2_weight, fc2_bias):
    """Linear -> GELU -> Linear."""
    return linear(gelu(linear(x, fc1_weight, fc1_bias)), fc2_weight, fc2_bias)


def mlp_swiglu(x, w12_weight, w12_bias, w3_weight, w3_bias):
    """SwiGLU (ViT-Giant): Linear(silu(a) * b) with a and b the two halves
    of one fused Linear ``w12`` (2 * hidden, F)."""
    a, b = linear(x, w12_weight, w12_bias).chunk(2, dim=-1)
    return linear(F.silu(a) * b, w3_weight, w3_bias)


def self_attention(
    tokens, qkv_weight, qkv_bias, proj_weight, proj_bias, num_heads: int, use_kernel: bool = True, bias=None
):
    """Fused-qkv multi-head self-attention. ``qkv_weight`` (3C, C) has its
    rows in head-major [head][q|k|v][dim] order, so the projection output is
    the slab the flash kernel reads with no transposes.

    ``bias``: None, a tensor broadcastable to (B, H, N, N), or a
    ``(stack, layer)`` tuple: a cached (L, H, Np, Np) per-layer stack plus
    the layer index, which the kernel reads in place (BEiT's cached mode).

    use_kernel=True sends the attention through ``flash_attention_fused_qkv``
    (on CUDA tensors, the hand-written kernel); False is the plain path,
    which materializes the layer's slice of a stack."""
    b, n, c = tokens.shape
    qkv = linear(tokens, qkv_weight, qkv_bias)  # (B, N, [h][3][d])
    bias_stack = layer = None
    if isinstance(bias, tuple):
        (bias_stack, layer), bias = bias, None
    if use_kernel:
        out = flash_attention_fused_qkv(qkv, num_heads, bias=bias, bias_stack=bias_stack, layer=layer)
    else:
        if bias_stack is not None:
            bias = bias_stack[layer][None]
        d = c // num_heads
        x = qkv.reshape(b, n, num_heads, 3, d)
        out = sdpa(x[..., 0, :], x[..., 1, :], x[..., 2, :], bias=bias).reshape(b, n, c)
    return linear(out, proj_weight, proj_bias)


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 0):
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def conv_transpose_blocky(x, weight, bias=None):
    """ConvTranspose2d with stride == kernel size (the reassembly upsamplers).
    weight: (in, out, k, k)."""
    return F.conv_transpose2d(x, weight, bias, stride=weight.shape[-1])


def patchify_embed(image_nchw, weight, bias=None):
    """Patch embedding: a stride == kernel conv. weight: (F, 3, P, P).
    Returns (tokens (B, gh*gw, F), (gh, gw))."""
    y = F.conv2d(image_nchw, weight, bias, stride=weight.shape[-1])  # (B, F, gh, gw)
    gh, gw = y.shape[-2:]
    return y.flatten(2).transpose(1, 2), (int(gh), int(gw))
