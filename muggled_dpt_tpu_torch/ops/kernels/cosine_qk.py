"""SwinV2's cosine normalization of q and k: a hand-written CUDA kernel with
its plain PyTorch version beside it. The C entry is ``csrc/cosine_qk.cu``.

``cosine_qk(q, k, logit_scale)`` takes the (B, nW, A, H, 32) q and k of a
SwinV2 block (strided views of its qkv output, the head dim contiguous) and
the block's (H,) logit scale, and returns ``(qs, kn)``: q l2-normalized over
the head dim and multiplied by its head's scale, and k l2-normalized, each a
new contiguous (B, nW, A, H, 32) tensor in q's dtype, what window attention
#3 reads. The arithmetic is the composite's (``cosine_normalize``, then the
scale fold and the casts), in float32, rounded once to q's dtype; the kernel
sums the squares in another order. It replaces no TPU kernel: the JAX package
leaves this to XLA. On the card it is bound by bytes, and the kernel moves q
and k once in and once out (the design is in the source's note).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. Launches are counted in ``launch_counts()``."""

from __future__ import annotations

import array
import ctypes

import torch

from . import _build
from .flash_attention import ATTENTION_DTYPE_CODES, _device_route, _operand, _refuse_grad
from .window_attention import HEAD_DIM

EPS = 1e-12


def cosine_normalize(x):
    """x * rsqrt(sum(x^2) + 1e-12) over the last axis, in float32."""
    x = x.float()
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + EPS)


def cosine_qk_reference(q, k, logit_scale):
    """Plain version: ``cosine_normalize`` of q and k, q's times its head's
    logit scale, both cast to q's dtype."""
    qf, kf = cosine_normalize(q), cosine_normalize(k)
    return (qf * logit_scale.float().reshape(q.shape[-2], 1)).to(q.dtype), kf.to(q.dtype)


def _check_shapes(q, k, logit_scale):
    if q.dim() != 5 or k.shape != q.shape:
        raise ValueError(f"cosine_qk: q and k must share one (B, nW, A, H, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if tuple(logit_scale.shape) != (q.shape[3],):
        raise ValueError(f"cosine_qk: logit_scale must be (H,) = ({q.shape[3]},), got {tuple(logit_scale.shape)}")


def _launch(q, k, logit_scale, qs, kn) -> None:
    """Launch the kernel on q's device. The arguments cross to C as one
    int64 array (slots in csrc/cosine_qk.cu)."""
    b, nw, a, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"cosine_qk kernel supports head_dim {HEAD_DIM} only, got {d}")
    if q.dtype not in ATTENTION_DTYPE_CODES:
        raise ValueError(f"cosine_qk kernel takes float32, bfloat16 or float16, got {q.dtype}")
    device = q.device
    specs = [_operand(name, t, device, q.dtype) for name, t in (("q", q), ("k", k))]
    if logit_scale.device != device or logit_scale.dtype != q.dtype or not logit_scale.is_contiguous():
        raise ValueError(f"cosine_qk kernel: logit_scale is {logit_scale.dtype} on {logit_scale.device}, want a "
                         f"contiguous {q.dtype} tensor on {device}")
    args = array.array("q", [*specs[0], *specs[1], logit_scale.data_ptr(), qs.data_ptr(), kn.data_ptr(), b, nw, a, h, d,
                             ATTENTION_DTYPE_CODES[q.dtype], device.index])
    stream = torch.cuda.current_stream(device).cuda_stream
    # mdpt_cosine_qk(the int64 argument array, stream)
    err = _build.kernel_entry("mdpt_cosine_qk", ctypes.c_void_p, ctypes.c_void_p)(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"cosine_qk kernel launch failed: CUDA error {err}")


def cosine_qk(q, k, logit_scale):
    """(q l2-normalized times its head's ``logit_scale``, k l2-normalized)
    over the head dim of (B, nW, A, H, D) q and k, each a new contiguous
    tensor in q's dtype. Counts its launches as the route ``cosine_qk``."""
    _check_shapes(q, k, logit_scale)
    if _device_route(q.device, "cosine_qk"):
        return cosine_qk_reference(q, k, logit_scale)
    _refuse_grad("cosine_qk", q, k, logit_scale)
    qs = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kn = torch.empty_like(qs)
    _launch(q, k, logit_scale, qs, kn)
    _build.count("cosine_qk")
    return qs, kn

