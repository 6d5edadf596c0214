"""SwinV2 window attention: a hand-written Hopper kernel
(``csrc/window_attention.cu``) with its plain PyTorch version beside it.

``window_attention(q, k, v, cpb, mask)`` replaces
``muggled_dpt_tpu/ops/pallas/window_attention.py:window_flash_attention``
(TPU kernel #3, ``_kernel``). Per (batch, window, head) it computes
softmax(q kᵀ + cpb[h] + mask[w]) v on (B, nW, A, H, D) tensors: q arrives
l2-normalized and multiplied by the block's logit scale, k l2-normalized, so
there is no scale. ``cpb`` is the (H, A, A) continuous-position bias and
``mask`` the optional (nW, A, A) shift mask of 0 / -100; the kernel reads
both by strides, so their (B, nW, H, A, A) sum never exists. q, k and v may
be strided views (the head dim contiguous); the output is a new (B, nW, A,
H, D) tensor in q's dtype.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. Launches are counted in
``window_attention.launches``, which ``flash_attention.launch_counts()``
reports as the route ``window``."""

from __future__ import annotations

import array

import torch

from ._build import kernel_library
from .flash_attention import _DTYPE_CODES, MAX_GRID_YZ, _device_route, _operand

HEAD_DIM = 32  # the only head width the kernel is built for (every SwinV2 config: F / H = 32)


def _check_shapes(q, k, v, cpb, mask):
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, nW, A, H, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _, nw, a, h, _ = q.shape
    if tuple(cpb.shape) != (h, a, a):
        raise ValueError(f"cpb must be (H, A, A) = {(h, a, a)}, got {tuple(cpb.shape)}")
    if mask is not None and tuple(mask.shape) != (nw, a, a):
        raise ValueError(f"mask must be (nW, A, A) = {(nw, a, a)}, got {tuple(mask.shape)}")


def window_attention_reference(q, k, v, cpb, mask=None) -> torch.Tensor:
    """Plain version: float32 logits plus cpb plus mask, float32 softmax,
    weights cast to v's dtype for the PV product. Returns (B, nW, A, H, D)
    in v's dtype."""
    logits = torch.einsum("bwnhd,bwmhd->bwhnm", q.float(), k.float())
    logits = logits + cpb.float()[None, None]
    if mask is not None:
        logits = logits + mask.float()[None, :, None]
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bwhnm,bwmhd->bwnhd", weights.to(v.dtype), v)


def _pairable(t: torch.Tensor) -> bool:
    """True if every row of a 3-d bias starts at an even element of an
    aligned base and its columns are contiguous: the kernel then loads
    element pairs."""
    s0, s1, s2 = t.stride()
    return s2 == 1 and s0 % 2 == 0 and s1 % 2 == 0 and t.data_ptr() % (2 * t.element_size()) == 0


def _bias_operands(cpb, mask, device):
    """(dtype code, cpb, mask) as the kernel reads them: both biases in one
    dtype (float32 when they differ: exact), every row starting at an even
    element. A bias that is not so laid out (an odd window area, say) is
    copied once into rows padded to a multiple of 8 with zeros."""
    for name, t in (("cpb", cpb), ("mask", mask)):
        if t is not None and (t.device != device or t.dtype not in _DTYPE_CODES):
            raise ValueError(f"window attention kernel: {name} is {t.dtype} on {t.device}, want float32 or bfloat16 on {device}")
    if mask is not None and mask.dtype != cpb.dtype:
        cpb, mask = cpb.float(), mask.float()

    def laid_out(t):
        if t is None or _pairable(t):
            return t
        a = t.shape[-1]
        padded = torch.zeros((*t.shape[:-1], (a + 7) // 8 * 8), dtype=t.dtype, device=t.device)
        padded[..., :a] = t
        return padded[..., :a]

    return _DTYPE_CODES[cpb.dtype], laid_out(cpb), laid_out(mask)


def _launch(shape, dtype, device, q, k, v, out, bias_code, cpb, mask):
    """Launch the kernel over (B, nW, A, H, D) = ``shape`` on ``device``. q,
    k, v and out are ``_operand`` tuples; cpb and mask come from
    ``_bias_operands`` (mask may be None). The arguments cross to C as one
    int64 array (slots in csrc/window_attention.cu); the C entry launches on
    the tensors' device and leaves the caller's current device as it was."""
    b, nw, a, h, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"window attention kernel supports head_dim {HEAD_DIM} only, got {d}")
    dtype_code = _DTYPE_CODES.get(dtype)
    if dtype_code is None:
        raise ValueError(f"window attention kernel takes float32 or bfloat16, got {dtype}")
    if min(b, nw, a, h) < 1 or b * nw > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"window attention kernel: bad grid batch={b} windows={nw} heads={h} area={a}")
    cpb_args = (cpb.data_ptr(), cpb.stride(0), cpb.stride(1))
    mask_args = (0, 0, 0) if mask is None else (mask.data_ptr(), mask.stride(0), mask.stride(1))
    args = array.array("q", [*q, *k, *v, *out, *cpb_args, *mask_args, b, nw, a, h, d, dtype_code, bias_code, device.index])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = kernel_library().mdpt_window_attention(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: CUDA error {err}")


def window_attention(q, k, v, cpb, mask=None):
    """softmax(q kᵀ + cpb[h] + mask[w]) v per (batch, window, head) on
    (B, nW, A, H, D) tensors; cpb (H, A, A), mask None or (nW, A, A), each
    float32 or bfloat16 whatever q's dtype. Counts its launches in
    ``window_attention.launches``."""
    _check_shapes(q, k, v, cpb, mask)
    device = q.device
    if _device_route(device, "window_attention"):
        return window_attention_reference(q, k, v, cpb, mask)
    specs = [_operand(name, t, device, q.dtype) for name, t in (("q", q), ("k", k), ("v", v))]
    bias_code, cpb, mask = _bias_operands(cpb, mask, device)
    b, nw, a, h, d = q.shape
    out = torch.empty((b, nw, a, h, d), dtype=q.dtype, device=device)
    o = (out.data_ptr(), nw * a * h * d, a * h * d, h * d, d)
    _launch(tuple(q.shape), q.dtype, device, *specs, o, bias_code, cpb, mask)
    window_attention.launches += 1
    return out


window_attention.launches = 0
