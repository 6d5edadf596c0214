"""Core functional NN ops on torch tensors.

Layouts are torch's own: Linear weights (out, in), conv weights OIHW,
transposed-conv weights (in, out, kh, kw), feature maps NCHW, tokens
(B, N, C). The JAX package's counterparts (``muggled_dpt_tpu/ops/nn.py``)
hold the same math in TPU layouts."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.observability import trace_span
from .collectives import copy_to_model, row_linear
from .kernels import library  # noqa: F401  (registers torch.ops.mdpt.*)
from .kernels.flash_attention import flash_attention_fused_qkv
from .kernels.flash_attention import flash_attention_reference as sdpa  # the plain attention path, JAX's name
from .kernels.swiglu_gate import swiglu_gate, swiglu_gate_reference
from .quant import linear_p


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


def mlp_gelu(x, fc1, fc2, group=None):
    """Linear -> GELU -> Linear. ``fc1`` and ``fc2`` are linear layers
    (``weight``, ``bias``) or ``QuantLinear``s (``ops/quant.py:linear_p``).
    ``group``: the model group of a tensor-parallel pair (``parallel/tensor.py``),
    fc1 holding this rank's hidden rows and fc2 its hidden columns."""
    if group is None:
        return linear_p(gelu(linear_p(x, fc1, "fc1")), fc2, "fc2")
    return row_linear(gelu(F.linear(copy_to_model(x, group), fc1.weight, fc1.bias)), fc2, group)


def mlp_swiglu(x, w12, w3, group=None, use_kernel: bool = True):
    """SwiGLU (ViT-Giant): Linear(silu(a) * b) with a and b the two halves
    of one fused Linear ``w12`` (2 * hidden, F). ``group``: as ``mlp_gelu``'s,
    w12 holding this rank's rows of each half. The ``gate`` span
    (``utils/observability.py``) holds silu(a) * b: with ``use_kernel`` one
    ``swiglu_gate`` launch for a CUDA tensor (its operator node while
    ``torch.export`` traces), else the composite."""
    if group is None:
        x12 = linear_p(x, w12, "w12")
    else:
        x12 = F.linear(copy_to_model(x, group), w12.weight, w12.bias)
    with trace_span("gate"):
        if not use_kernel:
            h = swiglu_gate_reference(x12)
        elif torch.compiler.is_exporting():
            h = torch.ops.mdpt.swiglu_gate(x12)
        else:
            h = swiglu_gate(x12)
    return linear_p(h, w3, "w3") if group is None else row_linear(h, w3, group)


def sdpa_capture(q, k, v, bias=None):
    """Attention with explicit weights, for capture: (B, N, H, D) q, k, v ->
    ((B, N, H, D) output in q's dtype, (B, H, N, N) float32 weights). The
    logits are float32 products of q * D**-0.5 and k, whatever the dtype; a
    bias pre-padded past N (BEiT's stack rows) is sliced back to (.., N,
    N). The counterpart of JAX ``sdpa(impl="naive")``."""
    n = q.shape[1]
    logits = torch.einsum("bnhd,bmhd->bhnm", (q * q.shape[-1] ** -0.5).float(), k.float())
    if bias is not None:
        logits = logits + bias[..., :n, :n].float()
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", weights.to(q.dtype), v), weights


def self_attention(tokens, qkv, proj, num_heads: int, use_kernel: bool = True, bias=None, capture: bool = False,
                   group=None):
    """Fused-qkv multi-head self-attention. ``qkv`` and ``proj`` are linear
    layers or ``QuantLinear``s (``ops/quant.py:linear_p``); the qkv weight
    (3C, C) has its rows in head-major [head][q|k|v][dim] order, so the
    projection output is the slab the flash kernel reads with no transposes.

    ``bias``: None, a tensor broadcastable to (B, H, N, N), or a
    ``(stack, layer)`` tuple: a cached (L, H, Np, Np) per-layer stack plus
    the layer index, which the kernel reads in place (BEiT's cached mode).

    use_kernel=True sends the attention through ``flash_attention_fused_qkv``
    (on CUDA tensors, the hand-written kernel); False is the plain path,
    which materializes the layer's slice of a stack.

    capture=True returns (out, weights) with the (B, H, N, N) float32
    softmax weights of ``sdpa_capture``, whatever ``use_kernel`` says: a
    flash kernel never holds them.

    ``group``: the model group of a tensor-parallel pair (``parallel/tensor.py``):
    qkv holds this rank's ``num_heads`` heads' rows and proj their columns,
    whose partial products are summed over the group before proj's bias.

    The ``attention`` span (``utils/observability.py``) holds the attention
    core: the kernel call, or the plain path."""
    b, n, _ = tokens.shape
    x = linear_p(tokens if group is None else copy_to_model(tokens, group), qkv, "qkv")  # (B, N, [h][3][d])
    bias_stack = layer = None
    if isinstance(bias, tuple):
        (bias_stack, layer), bias = bias, None
    weights = None
    with trace_span("attention"):
        if use_kernel and not capture:
            # while torch.export traces, the kernel is an operator node (ops/kernels/library.py)
            attend = torch.ops.mdpt.flash_attention_fused_qkv if torch.compiler.is_exporting() else flash_attention_fused_qkv
            out = attend(x, num_heads, bias=bias, bias_stack=bias_stack, layer=layer)
        else:
            if bias_stack is not None:
                bias = bias_stack[layer][None]
            x = x.reshape(b, n, num_heads, 3, -1)
            q, k, v = x[..., 0, :], x[..., 1, :], x[..., 2, :]
            if capture:
                out, weights = sdpa_capture(q, k, v, bias)
            else:
                out = sdpa(q, k, v, bias=bias)
            out = out.reshape(b, n, -1)
    out = linear_p(out, proj, "proj") if group is None else row_linear(out, proj, group)
    return (out, weights) if capture else out


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
