"""Flash attention with an int8 QK^T: one hand-written Hopper kernel
(``csrc/flash_attention_int8.cu``) behind two entries, each with its plain
PyTorch version beside it.

* ``flash_attention_int8_qk(q, k, v, scale)`` on (BH, N, D) tensors replaces
  ``experiments/flash_attention_int8.py:flash_attention_int8_qk`` (TPU
  kernel #6, ``_online_kernel_i8``): q is quantized per row, k per
  (batch * head), and alpha = sq * sk * scale * log2(e) is the row's logit
  scale in the exp2 domain.
* ``flash_attention_int8_qk_fused(qkv, num_heads, scale)`` on the head-major
  (B, N, 3C) qkv slab replaces ``flash_attention_int8_qk_fused`` (TPU
  kernel #7, ``_onepass_i8qk_kernel``): q is scaled by scale * log2(e) first,
  then quantized per (row, head), k per (batch, head), alpha = sq * sk; v is
  read in place in the slab. Returns (B, N, C).

The prologues (``quantize_rows``, ``quantize_fused``) copy the JAX package's
formula for formula (``:101-107``, ``:263-271``) in plain torch ops, as the
JAX package runs them in XLA outside its kernels. The kernel then computes
softmax over float(int32(q_i8 . k_i8)) * alpha in the exp2 domain and the
product with v in v's dtype (bfloat16 or float32). The plain version
(``int8_attention_reference``) keeps the TPU kernels' rounding points: the
exact integer logits times alpha in float32, p = exp2(s - max) cast to v's
dtype, the row sum over that cast p (the ones column of the TPU kernels'
v_ext), one division, one cast.

As in the JAX package, no model serves through these entries: the int8 tier
(``ops/quant.py``) quantizes the qkv projection, and chip_smoke.py holds the
kernel against the int8 DA-V2 ViT-L's own qkv slabs.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Launches are counted in ``flash_attention_int8_qk.launches`` and
``flash_attention_int8_qk_fused.launches``."""

from __future__ import annotations

import array

import torch

from ._build import kernel_library
from .flash_attention import HEAD_DIM, LOG2E, MAX_GRID_YZ, _device_route, _operand, _qkv_operands

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_rows(q, k, scale: float):
    """#6's prologue on (BH, N, D) q and k: (q_i8, k_i8, alpha (BH, N) float32)."""
    qf, kf = q.float(), k.float()
    sq = qf.abs().amax(dim=2).clamp_min(1e-12) / 127.0  # (BH, N)
    sk = kf.abs().amax(dim=(1, 2)).clamp_min(1e-12) / 127.0  # (BH,)
    q_i8 = torch.round(qf / sq[:, :, None]).to(torch.int8)
    k_i8 = torch.round(kf / sk[:, None, None]).to(torch.int8)
    return q_i8, k_i8, sq * sk[:, None] * scale * LOG2E


def quantize_fused(qkv, num_heads: int, scale: float):
    """#7's prologue on a head-major (B, N, 3C) qkv: (q_i8, k_i8 (B, N, H, D),
    alpha (B, N, H) float32, v (B, N, H, D), a view of the slab)."""
    b, n, c3 = qkv.shape
    hm = qkv.reshape(b, n, num_heads, 3, c3 // 3 // num_heads)
    qf = hm[..., 0, :].float() * (scale * LOG2E)
    kf = hm[..., 1, :].float()
    sq = qf.abs().amax(dim=3).clamp_min(1e-12) / 127.0  # (B, N, H)
    sk = kf.abs().amax(dim=(1, 3)).clamp_min(1e-12) / 127.0  # (B, H)
    q_i8 = torch.round(qf / sq[..., None]).to(torch.int8)
    k_i8 = torch.round(kf / sk[:, None, :, None]).to(torch.int8)
    return q_i8, k_i8, sq * sk[:, None, :], hm[..., 2, :]


REFERENCE_ROWS = 4096  # query rows per step of the plain version: (B, H, 4096, N) logits at a time


def int8_attention_reference(q_i8, k_i8, v, alpha):
    """Plain version of the kernel on (B, N, H, D) int8 q and k, v (B, N, H,
    D) and alpha (B, N, H): returns (B, N, H, D) in v's dtype. The integer
    logits are taken as a float32 product of int8 values: every partial sum
    is an integer below 2^24, so it is exact in any summation order. Query
    rows go in steps of ``REFERENCE_ROWS``, which changes no result."""
    kf, vf = k_i8.float(), v.float()
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for i in range(0, q_i8.shape[1], REFERENCE_ROWS):
        rows = slice(i, i + REFERENCE_ROWS)
        s = torch.einsum("bnhd,bmhd->bhnm", q_i8[:, rows].float(), kf)
        s = s * alpha[:, rows].permute(0, 2, 1)[..., None]
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
        l = p.sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, rows, H, 1): the ones column of v_ext
        out[:, rows] = (torch.einsum("bhnm,bmhd->bnhd", p, vf) / l.clamp_min(1e-30)).to(v.dtype)
    return out


def flash_attention_int8_qk_reference(q, k, v, scale=None):
    """Plain version of ``flash_attention_int8_qk``."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    q_i8, k_i8, alpha = quantize_rows(q, k, scale)
    return int8_attention_reference(q_i8[:, :, None], k_i8[:, :, None], v[:, :, None], alpha[..., None])[:, :, 0]


def flash_attention_int8_qk_fused_reference(qkv, num_heads: int, scale=None):
    """Plain version of ``flash_attention_int8_qk_fused``."""
    b, n, c3 = qkv.shape
    scale = (c3 // 3 // num_heads) ** -0.5 if scale is None else float(scale)
    q_i8, k_i8, alpha, v = quantize_fused(qkv, num_heads, scale)
    return int8_attention_reference(q_i8, k_i8, v, alpha).reshape(b, n, c3 // 3)


def _launch(shape, q_i8, k_i8, v_spec, alpha, dtype, device) -> torch.Tensor:
    """Launch the kernel over (B, N, H, D) = ``shape``: q_i8 and k_i8 (B, N,
    H, D) int8, ``v_spec`` v's (address, batch, row and head strides), alpha
    (B, N, H) float32. Returns a new (B, N, H, D) output in ``dtype``."""
    b, n, h, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"int8 flash attention kernel supports head_dim {HEAD_DIM} only, got {d}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"int8 flash attention kernel takes v in float32 or bfloat16, got {dtype}")
    if n < 1 or b < 1 or b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"int8 flash attention kernel: bad grid batch={b} heads={h} n={n}")
    if alpha.device != device or alpha.dtype != torch.float32 or tuple(alpha.shape) != (b, n, h):
        raise ValueError(f"int8 flash attention kernel: alpha must be float32 (B, N, H) on {device}, "
                         f"got {alpha.dtype} {tuple(alpha.shape)} on {alpha.device}")
    q = _operand("q_i8", q_i8, device, torch.int8)
    k = _operand("k_i8", k_i8, device, torch.int8)
    out = torch.empty((b, n, h, d), dtype=dtype, device=device)
    o = (out.data_ptr(), n * h * d, h * d, d)
    a_sb, a_sn, a_sh = alpha.stride()
    args = array.array("q", [*q, *k, *v_spec, *o, alpha.data_ptr(), a_sb, a_sh, a_sn, b, n, h, d,
                             _DTYPE_CODES[dtype], device.index])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = kernel_library().mdpt_flash_attention_int8(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"int8 flash attention kernel launch failed: CUDA error {err}")
    return out


def flash_attention_int8_qk(q, k, v, scale=None):
    """Attention with int8 QK^T on (BH, N, D) q, k and v (q unscaled);
    returns (BH, N, D) in v's dtype. Counts its launches in
    ``flash_attention_int8_qk.launches``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if _device_route(q.device, "flash_attention_int8_qk"):
        return flash_attention_int8_qk_reference(q, k, v, scale)
    bh, n, d = q.shape
    q_i8, k_i8, alpha = quantize_rows(q, k, d**-0.5 if scale is None else float(scale))
    v4 = v[:, :, None]
    out = _launch((bh, n, 1, d), q_i8[:, :, None], k_i8[:, :, None], _operand("v", v4, q.device, v.dtype),
                  alpha[..., None], v.dtype, q.device)
    flash_attention_int8_qk.launches += 1
    return out[:, :, 0]


def flash_attention_int8_qk_fused(qkv, num_heads, scale=None):
    """Attention with int8 QK^T off a head-major (B, N, 3C) qkv slab; returns
    (B, N, C) in qkv's dtype. Counts its launches in
    ``flash_attention_int8_qk_fused.launches``."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads) != 0:
        raise ValueError(f"qkv must be (B, N, 3 * num_heads * D), got {tuple(qkv.shape)} for {num_heads} heads")
    if _device_route(qkv.device, "flash_attention_int8_qk_fused"):
        return flash_attention_int8_qk_fused_reference(qkv, num_heads, scale)
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    q_i8, k_i8, alpha, _ = quantize_fused(qkv, num_heads, d**-0.5 if scale is None else float(scale))
    out = _launch((b, n, num_heads, d), q_i8, k_i8, _qkv_operands(qkv, d)[2], alpha, qkv.dtype, qkv.device)
    flash_attention_int8_qk_fused.launches += 1
    return out.reshape(b, n, c3 // 3)


flash_attention_int8_qk.launches = 0
flash_attention_int8_qk_fused.launches = 0
