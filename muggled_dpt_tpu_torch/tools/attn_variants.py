"""TPU kernel #12, the attention variant shootout's kernels: hand-written
Hopper kernels with their plain PyTorch version beside them. The C entry
is ``csrc/flash_variant.cu``: bfloat16 runs the wgmma/TMA kernel of
``csrc/flash_variant_sm90.cu`` (#1's pipeline, one instantiation per mode
and CTA height), float32 the FMA template of ``csrc/flash_variants.cuh``.
A measurement tool: no serving route calls it.

``flash_variant(q, k, v, mode, chunk)`` replaces
``tools/attn_variants.py:flash_variant`` (``_onepass_kernel`` and
``_innerloop_kernel``) on pre-scaled (BH, N, D) q, k and v, whose keys the
JAX wrapper zero-pads to a multiple of 128. Modes:

* ``mask_exp``, ``mask_exp2``: keys past N masked to -1e30, then a softmax
  in exp or exp2;
* ``padfix``: no mask: the pad keys' logits are 0 and count in the max, and
  pad_count * 2^-m is taken off the row sum. When every real logit is far
  below 0, the pad keys win the max, the real weights underflow and the
  correction cancels the whole sum: the output is wrong (the reason the
  serving kernels mask with -1e30 instead, as
  ``muggled_dpt_tpu/ops/pallas/flash_attention.py:16-20`` warns);
* ``chunk=c`` (any mode): an online softmax over key chunks of c with the
  same correction per chunk; keys past (N_pad // c) * c are not read;
* the ablations ``nosm`` (p = s), ``maxonly`` (p = s - max) and ``exponly``
  (p = exp2(s)), each with l = 1.

The JAX wrapper's ``block_q``, the TPU kernel's q tile, has no counterpart:
the bf16 kernel's CTA height is the C entry's choice, the f32 kernel's 64
rows. The JAX tool's ``main`` is part of the attention sweep, ``flash_tune.py``.

The kernel takes the keys the modes need as ``keys`` and reads rows at or
past N as zeros: the mask modes N keys, masked past N; padfix and the
ablations the N_pad keys, the pads' logit 0 in the max and the sum;
``chunk=c`` the (N_pad // c) c keys, with the pad correction once at the
end, which equals the JAX kernel's per-chunk corrections rescaled through
the online softmax.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Launches are counted as the route ``variant`` of ``launch_counts()``."""

from __future__ import annotations

import torch

from ..ops.kernels._build import NEG_INF, count, round_up
from ..ops.kernels.flash_attention import _device_route, _operand, _refuse_grad, reference_row_step
from ..ops.kernels.flash_variants import launch_variant

MODES = ("mask_exp", "mask_exp2", "padfix", "nosm", "maxonly", "exponly")


def _check(q, k, v, mode, chunk):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n_pad = round_up(q.shape[1], 128)
    if chunk is not None and not 1 <= chunk <= n_pad:
        raise ValueError(f"chunk must be in [1, {n_pad}] (the keys padded to 128), got {chunk}")
    return n_pad


def flash_variant_reference(q, k, v, mode: str = "padfix", chunk=None) -> torch.Tensor:
    """Plain version, step by step as the JAX kernels: k and v zero-padded
    to a multiple of 128, float32 logits against every padded key, then the
    mode's weights (the mask modes put -1e30 on the pad keys), PV with p cast
    to v's dtype, one division by max(l, 1e-30), one cast. ``chunk``: the
    online softmax over key chunks with the pad correction per chunk. Query
    rows go in steps of ``reference_row_step``. Returns (BH, N, D)."""
    n_pad = _check(q, k, v, mode, chunk)
    g, n, d = q.shape
    kp = torch.zeros((g, n_pad, d), dtype=torch.float32, device=q.device)
    vp = torch.zeros_like(kp)
    kp[:, :n], vp[:, :n] = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    step = reference_row_step(g, 1, n_pad)
    for i in range(0, n, step):
        qc = q[:, i : i + step].float()
        if chunk is not None:
            o = _innerloop_reference(qc, kp, vp, n, chunk, v.dtype)
        else:
            s = torch.einsum("gnd,gmd->gnm", qc, kp)
            l = torch.ones(s.shape[:2] + (1,), dtype=torch.float32, device=q.device)
            if mode in ("mask_exp", "mask_exp2"):
                s[:, :, n:] = NEG_INF
                p = (torch.exp2 if mode == "mask_exp2" else torch.exp)(s - s.amax(dim=-1, keepdim=True))
                l = p.sum(dim=-1, keepdim=True)
            elif mode == "nosm":
                p = s
            elif mode == "maxonly":
                p = s - s.amax(dim=-1, keepdim=True)
            elif mode == "exponly":
                p = torch.exp2(s)
            else:  # padfix
                m = s.amax(dim=-1, keepdim=True)
                p = torch.exp2(s - m)
                l = p.sum(dim=-1, keepdim=True) - (n_pad - n) * torch.exp2(-m)
            o = torch.einsum("gnm,gmd->gnd", p.to(v.dtype).float(), vp) / l.clamp_min(1e-30)
        out[:, i : i + o.shape[1]] = o.to(q.dtype)
    return out


def _innerloop_reference(q, kp, vp, n: int, chunk: int, dtype):
    """The JAX ``_innerloop_kernel``: an online softmax over the key chunks,
    each chunk's pad keys' weight taken off its row sum."""
    m = torch.full(q.shape[:2] + (1,), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(kp.shape[1] // chunk):
        lo, hi = i * chunk, (i + 1) * chunk
        s = torch.einsum("gnd,gmd->gnm", q, kp[:, lo:hi])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        lc = p.sum(dim=-1, keepdim=True)
        if hi > n:  # this chunk holds zero pad keys
            lc = lc - (hi - max(n, lo)) * torch.exp2(-m_new)
        l = l * corr + lc
        acc = acc * corr + torch.einsum("gnm,gmd->gnd", p.to(dtype).float(), vp[:, lo:hi])
        m = m_new
    return acc / l.clamp_min(1e-30)


def flash_variant(q, k, v, mode="padfix", chunk=None):
    """The variant kernel on pre-scaled (BH, N, D) q, k and v; returns
    (BH, N, D) in q's dtype. Counts its launches as the route ``variant``."""
    n_pad = _check(q, k, v, mode, chunk)
    if _device_route(q.device, "flash_variant"):
        return flash_variant_reference(q, k, v, mode, chunk)
    _refuse_grad("flash_variant", q, k, v)
    g, n, d = q.shape
    device = q.device
    specs = [_operand(name, t[:, :, None], device, q.dtype) for name, t in (("q", q), ("k", k), ("v", v))]
    out = torch.empty(q.shape, dtype=q.dtype, device=device)
    o = (out.data_ptr(), n * d, d, d)
    if chunk is not None:  # chunk mode: one correction per chunk, keys past the last whole chunk not read
        kw = {"mode": "padfix", "keys": n_pad // chunk * chunk, "chunk": chunk}
    elif mode == "padfix":  # one chunk of every padded key
        kw = {"mode": "padfix", "keys": n_pad, "chunk": n_pad}
    elif mode in ("mask_exp", "mask_exp2"):
        kw = {"mode": mode, "keys": n}
    else:
        kw = {"mode": mode, "keys": n_pad, "panel": n_pad}  # maxonly: one panel
    launch_variant("mdpt_flash_variant", (g, n, 1, d), q.dtype, device, *specs, o, qk_scale=1.0, **kw)
    count("variant")
    return out

