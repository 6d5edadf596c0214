"""Fused-qkv flash attention: the hand-written Hopper kernel
(``csrc/flash_attention_fused_qkv.cu``) and its plain PyTorch version.

Replaces the TPU kernel
``muggled_dpt_tpu/ops/pallas/flash_attention.py:flash_attention_fused_qkv``
(``_onepass_qkv_kernel``, unbiased path). The input is the fused qkv
projection output, (B, N, 3C) with columns in head-major [head][q|k|v][dim]
order (``checkpoints/convert_common.py:qkv_head_major``); the output is
(B, N, C) with head h in columns [h*D, (h+1)*D).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback."""

from __future__ import annotations

import math

import torch

from ._build import kernel_library

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the only head width the kernel is built for (every DA config: F // 64 heads)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fused_qkv_reference(qkv: torch.Tensor, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Plain version: explicit float32 softmax attention on the split q, k
    and v of a head-major (B, N, 3C) qkv tensor. Returns (B, N, C) in the
    input's dtype."""
    from ..nn import sdpa

    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    x = qkv.float().reshape(b, n, num_heads, 3, d)
    out = sdpa(x[..., 0, :], x[..., 1, :], x[..., 2, :], scale=scale)
    return out.reshape(b, n, num_heads * d).to(qkv.dtype)


def flash_attention_fused_qkv(qkv: torch.Tensor, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v per head, read straight from the head-major
    qkv slab. ``scale`` defaults to D ** -0.5. Counts its launches in
    ``flash_attention_fused_qkv.launches``."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads) != 0:
        raise ValueError(f"qkv must be (B, N, 3 * num_heads * D), got {tuple(qkv.shape)} for {num_heads} heads")
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    scale = d**-0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return flash_attention_fused_qkv_reference(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_fused_qkv: unsupported device {qkv.device}")
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention_fused_qkv kernel supports head_dim {HEAD_DIM} only, got {d}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_fused_qkv kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16 != 0:
        raise ValueError("flash_attention_fused_qkv kernel needs a contiguous, 16-byte aligned qkv")
    if not math.isfinite(scale):
        raise ValueError(f"flash_attention_fused_qkv kernel needs a finite scale, got {scale}")
    if n < 1 or b < 1 or b > 65535 or num_heads > 65535:
        raise ValueError(f"flash_attention_fused_qkv kernel: bad grid batch={b} heads={num_heads} n={n}")
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    lib = kernel_library()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.mdpt_flash_attention_fused_qkv(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, scale * LOG2E, _DTYPE_CODES[qkv.dtype], qkv.device.index, stream
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fused_qkv kernel launch failed: CUDA error {err}")
    flash_attention_fused_qkv.launches += 1
    return out


flash_attention_fused_qkv.launches = 0
