"""SwinV2 window attention: hand-written Hopper kernels behind one C entry
(``csrc/window_attention.cu``) with their plain PyTorch version beside them.

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

The C entry picks the kernel and reports it back through the argument
array's ``SLOT_ROUTE`` (T: bfloat16 or float16, each with its own instances):

=====================================  =====================================
T q/k/v, T CPB and mask, every         ``csrc/window_attention_sm90.cu``
operand readable by a tensor map       (wgmma, TMA, a warp-specialised
                                       producer); the route ``window_sm90``
                                       (float16: ``window_sm90_f16``)
float32; T q/k/v with float32          ``csrc/window_attention.cu`` (T on
biases (SwinV2's inline CPB); other    ``mma.sync``, float32 on FMAs);
layouts                                the route ``window`` (float16:
                                       ``window_f16``)
=====================================  =====================================

The wrapper lays a bias out for its route (``_bias_operands``): with T q/k/v
and T biases every bias row starts at a multiple of 8 elements (16 bytes,
what a tensor map reads), so every layout the SwinV2 model sends takes the
sm_90 kernel; otherwise every row starts at an even element.

A CPU tensor takes the plain version. A CUDA tensor launches a kernel or
raises; there is no fallback (float16 q, k and v launch a float16 kernel: they
are never cast). Each launch is counted under its route in ``launch_counts()``."""

from __future__ import annotations

import array
import ctypes

import torch

from . import _build
from .flash_attention import ATTENTION_DTYPE_CODES, HALF_TYPES, MAX_GRID_YZ, _device_route, _operand, _refuse_grad

HEAD_DIM = 32  # the only head width the kernel is built for (every SwinV2 config: F / H = 32)
# H100 SXM rates of the yardsticks below: dense bf16 tensor cores, HBM, and
# the SFU's ex2 (16 per clock per SM, 132 SMs, 1.83 GHz)
BF16_FLOPS_PER_S, HBM_BYTES_PER_S, EX2_PER_S = 989e12, 3.35e12, 16 * 132 * 1.83e9


def window_bound(b, nw, a, h, with_mask) -> dict:
    """The yardsticks of one 16-bit call (bf16 or f16: the same tensor-core
    rate and bytes on an H100) at (B, nW, A, H, D=32), in ms:
    ``bound_ms``, the larger of 4 B nW H A^2 D operations over the tensor
    cores' rate and q, k, v, out and the CPB and mask tables moved once over
    HBM's (``bound_by`` names which), and ``exp_floor_ms``, one ex2 per
    (q, k) pair over the SFU's rate."""
    pairs = b * nw * h * a * a
    ops_ms = 4 * pairs * HEAD_DIM / BF16_FLOPS_PER_S * 1e3
    bytes_ms = (4 * b * nw * a * h * HEAD_DIM + h * a * a + (nw * a * a if with_mask else 0)) * 2 / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "exp_floor_ms": pairs / EX2_PER_S * 1e3}


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


SM90_ROUTE = 1  # the value the C entry writes to SLOT_ROUTE when window_attention_sm90.cu ran
SLOT_ROUTE = 34  # the argument array's last slot (enum Slot in csrc/window_attention.cu)


def _row_aligned(t: torch.Tensor, step: int) -> bool:
    """True if every row of a 3-d bias starts at a multiple of ``step``
    elements of a base aligned to as many, and its columns are contiguous."""
    s0, s1, s2 = t.stride()
    return s2 == 1 and s0 % step == 0 and s1 % step == 0 and t.data_ptr() % (step * t.element_size()) == 0


def _bias_operands(cpb, mask, device, dtype=torch.float32):
    """(dtype code, cpb, mask) as the kernels read them: both biases in one
    dtype, float32 when they differ, and float32 where their 16-bit type has
    no instance beside ``dtype`` (q's): float16 biases with float32 or
    bfloat16 q, bfloat16 biases with float16 q (each cast exact). With
    16-bit q and biases of q's type every row starts at a multiple of 8
    elements, 16 bytes, so that a tensor map reads it (the sm_90 kernel);
    otherwise at an even element (the kernels load element pairs). A bias
    that is not so laid out (an odd window area, say) is copied once into
    rows padded to a multiple of 8 with zeros."""
    for name, t in (("cpb", cpb), ("mask", mask)):
        if t is not None and (t.device != device or t.dtype not in ATTENTION_DTYPE_CODES):
            raise ValueError(f"window attention kernel: {name} is {t.dtype} on {t.device}, "
                             f"want float32, bfloat16 or float16 on {device}")
    no_instance = (cpb.dtype == torch.float16) != (dtype == torch.float16) and cpb.dtype != torch.float32
    if mask is not None and mask.dtype != cpb.dtype or no_instance:
        cpb, mask = cpb.float(), None if mask is None else mask.float()
    step = 8 if dtype in HALF_TYPES and cpb.dtype == dtype else 2

    def laid_out(t):
        if t is None or _row_aligned(t, step):
            return t
        a = t.shape[-1]
        padded = torch.zeros((*t.shape[:-1], (a + 7) // 8 * 8), dtype=t.dtype, device=t.device)
        padded[..., :a] = t
        return padded[..., :a]

    return ATTENTION_DTYPE_CODES[cpb.dtype], laid_out(cpb), laid_out(mask)


def _launch(shape, dtype, device, q, k, v, out, bias_code, cpb, mask):
    """Launch the kernel over (B, nW, A, H, D) = ``shape`` on ``device``. q,
    k, v and out are ``_operand`` tuples; cpb and mask come from
    ``_bias_operands`` (mask may be None). The arguments cross to C as one
    int64 array (slots in csrc/window_attention.cu); the C entry launches on
    the tensors' device, leaves the caller's current device as it was and
    writes the kernel it chose to ``SLOT_ROUTE``. Returns True if that was
    the sm_90 kernel."""
    b, nw, a, h, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"window attention kernel supports head_dim {HEAD_DIM} only, got {d}")
    dtype_code = ATTENTION_DTYPE_CODES.get(dtype)
    if dtype_code is None:
        raise ValueError(f"window attention kernel takes float32, bfloat16 or float16, got {dtype}")
    if min(b, nw, a, h) < 1 or b * nw > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"window attention kernel: bad grid batch={b} windows={nw} heads={h} area={a}")
    cpb_args = (cpb.data_ptr(), cpb.stride(0), cpb.stride(1))
    mask_args = (0, 0, 0) if mask is None else (mask.data_ptr(), mask.stride(0), mask.stride(1))
    args = array.array("q", [*q, *k, *v, *out, *cpb_args, *mask_args, b, nw, a, h, d, dtype_code, bias_code, device.index, 0])
    stream = torch.cuda.current_stream(device).cuda_stream
    # mdpt_window_attention(the int64 argument array, stream)
    err = _build.kernel_entry("mdpt_window_attention", ctypes.c_void_p, ctypes.c_void_p)(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: CUDA error {err}")
    return args[SLOT_ROUTE] == SM90_ROUTE


def window_attention(q, k, v, cpb, mask=None):
    """softmax(q kᵀ + cpb[h] + mask[w]) v per (batch, window, head) on
    (B, nW, A, H, D) tensors; cpb (H, A, A), mask None or (nW, A, A), each
    float32, bfloat16 or float16 whatever q's dtype. Counts its launches as
    the route ``window_sm90`` (csrc/window_attention_sm90.cu) or ``window``
    (csrc/window_attention.cu); float16 ones as ``window_sm90_f16`` and
    ``window_f16``."""
    _check_shapes(q, k, v, cpb, mask)
    device = q.device
    if _device_route(device, "window_attention"):
        return window_attention_reference(q, k, v, cpb, mask)
    _refuse_grad("window_attention", q, k, v, cpb, mask)
    specs = [_operand(name, t, device, q.dtype) for name, t in (("q", q), ("k", k), ("v", v))]
    bias_code, cpb, mask = _bias_operands(cpb, mask, device, q.dtype)
    b, nw, a, h, d = q.shape
    out = torch.empty((b, nw, a, h, d), dtype=q.dtype, device=device)
    o = (out.data_ptr(), nw * a * h * d, a * h * d, h * d, d)
    sm90 = _launch(tuple(q.shape), q.dtype, device, *specs, o, bias_code, cpb, mask)
    _build.count(("window_sm90" if sm90 else "window") + ("_f16" if q.dtype == torch.float16 else ""))
    return out

