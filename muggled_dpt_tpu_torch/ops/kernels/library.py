"""The serving kernels as PyTorch operators, for ``torch.export``.

The kernels reach CUDA through ctypes on raw ``data_ptr()`` addresses
(``flash_attention._launch``, ``window_attention._launch``), which
``torch.export`` cannot follow: it traces with fake tensors, which have no
storage. Here each serving entry gets an operator identity of its own, a
``torch.library.custom_op``, so that an exported program holds one node per
call and runs the kernel when it is called:

=================================  ==========================================
``mdpt::flash_attention_fused_qkv``  ``flash_attention.flash_attention_fused_qkv``:
                                   TPU kernels #1 (unbiased) and #2 (``bias``,
                                   or ``bias_stack`` + ``layer``)
``mdpt::window_attention``         ``window_attention.window_attention``: TPU
                                   kernel #3
``mdpt::upsample_bilinear_ac``     ``upsample.upsample_bilinear_ac``: the
                                   neck's bilinear align_corners=True upsample
``mdpt::cosine_qk``                ``cosine_qk.cosine_qk``: SwinV2's cosine
                                   normalization of q and k, the logit scale
                                   folded into q
``mdpt::postnorm_residual``        ``postnorm_residual.postnorm_residual``:
                                   SwinV2's post-norm residual, the window
                                   merge and the roll back folded in
``mdpt::swiglu_gate``              ``swiglu_gate.swiglu_gate``: ViT-Giant's
                                   SwiGLU gate, silu(a) * b over w12's output
=================================  ==========================================

The real implementation of each is the wrapper itself, called on real
tensors when the op runs: on a CPU tensor the plain version, on a CUDA
tensor the kernel or an exception, never a fallback. Every ``data_ptr()``,
operand layout check, bias fill choice and launch count happens there, so a
reloaded exported program counts its launches when it is called, not when it
is traced. The fake implementation only says the output's shape and dtype.

The ops have no backward (the kernels have none): the wrapper's
``_refuse_grad`` raises when an operand requires grad under autograd, as it
does when the wrapper is called directly.

Importing this module registers the ops; ``torch.export.load`` of a
program that holds them needs that import first. Only the serving call
sites use them, and only while a model is being exported
(``torch.compiler.is_exporting()``): eager serving calls the wrappers
directly, since the dispatcher adds a host cost to every call
(``tools/measure.py host``)."""

from __future__ import annotations

import torch

from . import cosine_qk as cq
from . import flash_attention as fa
from . import postnorm_residual as pr
from . import swiglu_gate as sg
from . import upsample as up
from . import window_attention as wa


@torch.library.custom_op("mdpt::flash_attention_fused_qkv", mutates_args=())
def flash_attention_fused_qkv(qkv: torch.Tensor, num_heads: int, bias: torch.Tensor | None = None,
                              scale: float | None = None, bias_stack: torch.Tensor | None = None,
                              layer: int | None = None) -> torch.Tensor:
    """``flash_attention.flash_attention_fused_qkv`` as an operator: (B, N, 3C) head-major qkv -> (B, N, C)."""
    return fa.flash_attention_fused_qkv(qkv, num_heads, bias, scale, bias_stack, layer)


@flash_attention_fused_qkv.register_fake
def _(qkv, num_heads, bias=None, scale=None, bias_stack=None, layer=None):
    b, n, c3 = qkv.shape
    return qkv.new_empty((b, n, c3 // 3))


def _register_refusal(op, name: str):
    """The op's autograd registration: the wrappers' ``_refuse_grad`` where
    the dispatcher records the call. Autograd runs an op whose operand
    requires grad inside an ``autograd.Function``, with grad mode off, so
    the wrapper cannot see that the call is recorded; the op raises from its
    context setup instead, after the call and before the caller gets the
    output."""

    def setup_context(ctx, inputs, output):
        with torch.enable_grad():
            fa._refuse_grad(name, *inputs)

    def backward(ctx, *grads):  # never reached: setup_context raised
        raise RuntimeError(f"{name} has no backward")

    op.register_autograd(backward, setup_context=setup_context)


_register_refusal(flash_attention_fused_qkv, "mdpt::flash_attention_fused_qkv")


@torch.library.custom_op("mdpt::window_attention", mutates_args=())
def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cpb: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """``window_attention.window_attention`` as an operator: (B, nW, A, H, D)
    q, k, v -> a new contiguous (B, nW, A, H, D) tensor (the kernel writes
    one; the plain version's einsum leaves its dims permuted, so it is
    copied: an operator's output has one layout)."""
    return wa.window_attention(q, k, v, cpb, mask).contiguous()


@window_attention.register_fake
def _(q, k, v, cpb, mask=None):
    return q.new_empty(q.shape)


_register_refusal(window_attention, "mdpt::window_attention")


@torch.library.custom_op("mdpt::upsample_bilinear_ac", mutates_args=())
def upsample_bilinear_ac(x: torch.Tensor, out_hw: list[int]) -> torch.Tensor:
    """``upsample.upsample_bilinear_ac`` as an operator: (B, C, H, W) -> a
    new (B, C, *out_hw) tensor in x's memory format."""
    return up.upsample_bilinear_ac(x, out_hw)


@upsample_bilinear_ac.register_fake
def _(x, out_hw):
    return up.empty_output(x, out_hw)


_register_refusal(upsample_bilinear_ac, "mdpt::upsample_bilinear_ac")


@torch.library.custom_op("mdpt::cosine_qk", mutates_args=())
def cosine_qk(q: torch.Tensor, k: torch.Tensor, logit_scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_qk.cosine_qk`` as an operator: (B, nW, A, H, D) q and k and
    the (H,) logit scale -> two new contiguous (B, nW, A, H, D) tensors in
    q's dtype."""
    return cq.cosine_qk(q, k, logit_scale)


@cosine_qk.register_fake
def _(q, k, logit_scale):
    return q.new_empty(q.shape), q.new_empty(q.shape)


_register_refusal(cosine_qk, "mdpt::cosine_qk")


@torch.library.custom_op("mdpt::postnorm_residual", mutates_args=())
def postnorm_residual(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      window_hw: list[int] | None = None, shift_hw: list[int] | None = None) -> torch.Tensor:
    """``postnorm_residual.postnorm_residual`` as an operator: (B, H, W, C) x,
    h in window order (``window_hw``) or x's shape -> a new contiguous
    (B, H, W, C) tensor in x's dtype."""
    return pr.postnorm_residual(x, h, weight, bias, window_hw, shift_hw)


@postnorm_residual.register_fake
def _(x, h, weight, bias, window_hw=None, shift_hw=None):
    return x.new_empty(x.shape)


_register_refusal(postnorm_residual, "mdpt::postnorm_residual")


@torch.library.custom_op("mdpt::swiglu_gate", mutates_args=())
def swiglu_gate(x12: torch.Tensor) -> torch.Tensor:
    """``swiglu_gate.swiglu_gate`` as an operator: w12's (..., 2H) output ->
    a new contiguous (..., H) tensor in x12's dtype."""
    return sg.swiglu_gate(x12)


@swiglu_gate.register_fake
def _(x12):
    return x12.new_empty((*x12.shape[:-1], x12.shape[-1] // 2))


_register_refusal(swiglu_gate, "mdpt::swiglu_gate")
