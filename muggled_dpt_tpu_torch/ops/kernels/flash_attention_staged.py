"""TPU kernel #11, staged (key-panel) flash attention: hand-written Hopper
kernels with their plain PyTorch version beside them. bfloat16 runs
``csrc/flash_staged_sm90.cu`` (#1's wgmma/TMA pipeline: pass 1 the row max
with the next tile's QK^T in flight, pass 2 exp2 and PV with no rescale);
float32 runs the FMA kernel of ``csrc/flash_variants.cuh``. The C entry is
``csrc/flash_attention_staged.cu``.

``flash_attention_fused_qkv_staged(qkv, num_heads, scale, panels)`` replaces
``experiments/flash_attention_staged.py:flash_attention_fused_qkv_staged``
(``_staged_qkv_kernel``): #1 on the head-major (B, N, 3C) qkv slab,
unbiased, as a two-pass schedule with no online rescaling. Phase 1 takes
every key panel's logits and the running row max; phase 2 takes exp2(s - m)
and PV per panel, plus the row sum. The -1e30 pad mask applies before the
max and touches only the last panel. The panels are ``_panel_bounds`` over
the keys padded to a multiple of 128 (the port's own copy: the JAX module
imports jax). The JAX wrapper's ``block_q`` and ``hpp``, the TPU kernel's VMEM
tactics, have no counterpart: the CUDA grid has 192 q rows in bf16, 64 in
f32, and one head per CTA. As in the JAX package, no model serves through it:
it is a variant of the attention sweep
(``muggled_dpt_tpu_torch/tools/flash_tune.py``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Launches are counted as the route ``staged`` of ``launch_counts()``
(bfloat16 ones all run the sm_90 kernel)."""

from __future__ import annotations

import torch

from ._build import NEG_INF, count, round_up
from .flash_attention import LOG2E, _device_route, _qkv_operands, _refuse_grad, reference_row_step
from .flash_variants import launch_variant, qkv_dims


def _panel_bounds(n_pad: int, panels: int) -> tuple[int, ...]:
    """Static panel boundaries over the padded key axis: ``panels`` slices of
    128-multiple width (the last takes the remainder, which is a 128-multiple
    because n_pad is). The JAX package's ``_panel_bounds``
    (``experiments/flash_attention_staged.py:60``)."""
    if panels <= 1:
        return (0, n_pad)
    pk = round_up(-(-n_pad // panels), 128)
    bounds = list(range(0, n_pad, pk)) + [n_pad]
    if len(bounds) >= 2 and bounds[-1] == bounds[-2]:  # collapse a degenerate final step (n_pad a multiple of pk)
        bounds.pop()
    return tuple(bounds)


def flash_attention_fused_qkv_staged_reference(qkv, num_heads: int, scale=None, panels: int = 2):
    """Plain version, step by step: keys zero-padded to a multiple of 128,
    q scaled by scale * log2(e); per panel the float32 logits with -1e30 on
    the pad keys and the panel's row max; the row max over the panels; per
    panel exp2(s - m), its row sum and its PV with p cast to qkv's dtype;
    the sums added panel by panel, one division, one cast. Query rows go in
    steps of ``reference_row_step``. Returns (B, N, C)."""
    b, n, d = qkv_dims(qkv, num_heads)
    scale = d**-0.5 if scale is None else float(scale)
    n_pad = round_up(n, 128)
    bounds = _panel_bounds(n_pad, panels)
    x = qkv.reshape(b, n, num_heads, 3, d)
    kv = torch.zeros((b, n_pad, num_heads, 2, d), dtype=torch.float32, device=qkv.device)
    kv[:, :n] = x[..., 1:, :].float()
    mask = torch.zeros(n_pad, dtype=torch.float32, device=qkv.device)
    mask[n:] = NEG_INF
    out = torch.empty((b, n, num_heads, d), dtype=qkv.dtype, device=qkv.device)
    step = reference_row_step(b, num_heads, n_pad)
    for i in range(0, n, step):
        rows = slice(i, i + step)
        q = x[:, rows, :, 0, :].float() * (scale * LOG2E)
        logits, m = [], None
        for lo, hi in zip(bounds[:-1], bounds[1:]):  # phase 1: panel logits and the running row max
            s = torch.einsum("bnhd,bmhd->bhnm", q, kv[:, lo:hi, :, 0]) + mask[lo:hi]
            logits.append(s)
            mc = s.amax(dim=-1, keepdim=True)
            m = mc if m is None else torch.maximum(m, mc)
        acc = l = None
        for (lo, hi), s in zip(zip(bounds[:-1], bounds[1:]), logits):  # phase 2: exp2, row sum, PV per panel
            p = torch.exp2(s - m)
            pv = torch.einsum("bhnm,bmhd->bnhd", p.to(qkv.dtype).float(), kv[:, lo:hi, :, 1])
            lc = p.sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, rows, H, 1)
            acc, l = (pv, lc) if acc is None else (acc + pv, l + lc)
        out[:, rows] = (acc / l.clamp_min(1e-30)).to(qkv.dtype)
    return out.reshape(b, n, num_heads * d)


def flash_attention_fused_qkv_staged(qkv, num_heads, scale=None, panels=2):
    """Unbiased attention off a head-major (B, N, 3C) qkv slab by the staged
    two-pass schedule; returns (B, N, C) in qkv's dtype. ``panels``: the key
    panels of ``_panel_bounds``, each reducing its own max before pass 2
    reads their maximum; the output does not depend on them beyond float32
    round-off. Counts its launches as the route ``staged``."""
    b, n, d = qkv_dims(qkv, num_heads)
    scale = d**-0.5 if scale is None else float(scale)
    device = qkv.device
    if _device_route(device, "flash_attention_fused_qkv_staged"):
        return flash_attention_fused_qkv_staged_reference(qkv, num_heads, scale, panels)
    _refuse_grad("flash_attention_fused_qkv_staged", qkv)
    bounds = _panel_bounds(round_up(n, 128), panels)
    q, k, v = _qkv_operands(qkv, d)
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=device)
    o = (out.data_ptr(), n * num_heads * d, num_heads * d, d)
    launch_variant("mdpt_flash_attention_staged", (b, n, num_heads, d), qkv.dtype, device, q, k, v, o, keys=n,
                   mode="staged", qk_scale=scale * LOG2E, panel=bounds[1] - bounds[0])
    count("staged")
    return out

