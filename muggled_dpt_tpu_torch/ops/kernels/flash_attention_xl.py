"""TPU kernel #10, the XL-N variants of flash attention #1: hand-written
Hopper kernels with their plain PyTorch version beside them. bfloat16 runs
``csrc/flash_xl_sm90.cu`` (#1's wgmma/TMA pipeline, one instantiation per
qp, pipelining and mode); float32 runs the FMA kernel of
``csrc/flash_variants.cuh``. The C entry is ``csrc/flash_attention_xl.cu``.

``flash_attention_fused_qkv_xl(qkv, num_heads, scale, qp, pipelined,
ablate_softmax)`` replaces
``experiments/flash_attention_xl.py:flash_attention_fused_qkv_xl``
(``_xl_qkv_kernel``): #1 on the head-major (B, N, 3C) qkv slab, unbiased,
D = 64, with ``qp`` q blocks of 64 rows per CTA sharing each K/V tile (in
bf16: ``qp`` consumer warpgroups on one TMA ring) and ``pipelined`` issuing
key tile t+1's QK^T before tile t's softmax (in bf16: two S tiles in
registers, the next tile's QK^T wgmma in flight under this tile's softmax).
``ablate_softmax`` gives p = (s * 1e-6) cast to v's dtype and o = p v, with
no max, sum or division: the kernel structure's timing floor, not a valid
attention. The JAX wrapper's ``block_q`` and ``hpp``, the TPU kernel's VMEM
tactics, have no counterpart: the CUDA grid has 64 * qp q rows per CTA and
one head per CTA. As in the JAX package, no model serves through it: it is a
variant of the attention sweep (``muggled_dpt_tpu_torch/tools/flash_tune.py``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Launches are counted as the route ``xl`` of ``launch_counts()``
(bfloat16 ones all run the sm_90 kernels)."""

from __future__ import annotations

import torch

from ._build import count
from .flash_attention import (
    LOG2E,
    _device_route,
    _qkv_operands,
    _refuse_grad,
    flash_attention_fused_qkv_reference,
    reference_row_step,
)
from .flash_variants import QP_CHOICES, launch_variant, qkv_dims


def ablation_reference(qkv, num_heads: int, scale=None) -> torch.Tensor:
    """Plain version of the ablation: float32 exp2-domain logits s = (q . k)
    * scale * log2(e), p = (s * 1e-6) cast to qkv's dtype, o = p v in float32,
    cast once. Returns (B, N, C)."""
    b, n, d = qkv_dims(qkv, num_heads)
    scale = d**-0.5 if scale is None else float(scale)
    x = qkv.reshape(b, n, num_heads, 3, d)
    kf, vf = x[..., 1, :].float(), x[..., 2, :].float()
    out = torch.empty((b, n, num_heads, d), dtype=qkv.dtype, device=qkv.device)
    step = reference_row_step(b, num_heads, n)
    for i in range(0, n, step):
        rows = slice(i, i + step)
        s = torch.einsum("bnhd,bmhd->bhnm", x[:, rows, :, 0, :].float(), kf) * (scale * LOG2E)
        p = (s * 1e-6).to(qkv.dtype).float()
        out[:, rows] = torch.einsum("bhnm,bmhd->bnhd", p, vf).to(qkv.dtype)
    return out.reshape(b, n, num_heads * d)


def flash_attention_fused_qkv_xl_reference(qkv, num_heads: int, scale=None, ablate_softmax: bool = False):
    """Plain version of ``flash_attention_fused_qkv_xl``: #1's plain version
    (``qp`` and ``pipelined`` change the schedule, not the function), or
    ``ablation_reference``."""
    if ablate_softmax:
        return ablation_reference(qkv, num_heads, scale)
    return flash_attention_fused_qkv_reference(qkv, num_heads, scale=scale)


def flash_attention_fused_qkv_xl(qkv, num_heads, scale=None, qp=1, pipelined=True, ablate_softmax=False):
    """Unbiased attention off a head-major (B, N, 3C) qkv slab; returns
    (B, N, C) in qkv's dtype. ``qp``: q blocks of 64 rows per CTA (1, 2 or
    4); ``pipelined``: the next key tile's QK^T before this tile's softmax;
    ``ablate_softmax``: the no-softmax timing floor. Counts its launches as
    the route ``xl``."""
    b, n, d = qkv_dims(qkv, num_heads)
    if qp not in QP_CHOICES:
        raise ValueError(f"qp must be one of {QP_CHOICES}, got {qp}")
    scale = d**-0.5 if scale is None else float(scale)
    device = qkv.device
    if _device_route(device, "flash_attention_fused_qkv_xl"):
        return flash_attention_fused_qkv_xl_reference(qkv, num_heads, scale, ablate_softmax)
    _refuse_grad("flash_attention_fused_qkv_xl", qkv)
    q, k, v = _qkv_operands(qkv, d)
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=device)
    o = (out.data_ptr(), n * num_heads * d, num_heads * d, d)
    launch_variant("mdpt_flash_attention_xl", (b, n, num_heads, d), qkv.dtype, device, q, k, v, o, keys=n,
                   mode="ablate" if ablate_softmax else "flash", qk_scale=scale * LOG2E, qp=qp, pipelined=bool(pipelined))
    count("xl")
    return out

