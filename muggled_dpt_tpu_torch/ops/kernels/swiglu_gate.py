"""ViT-Giant's SwiGLU gate: a hand-written CUDA kernel with its plain
PyTorch version beside it. The C entry is ``csrc/swiglu_gate.cu``.

``swiglu_gate(x12)`` takes w12's contiguous (..., 2H) output and returns
``silu(x12[..., :H]) * x12[..., H:]`` as a new contiguous (..., H) tensor in
x12's dtype. The arithmetic is the composite's (``F.silu`` in float32
rounded to the dtype, then the product in float32 rounded once), so the
kernel is bit-equal to it. It replaces no TPU kernel: the JAX package leaves
the gate to XLA. On the card it is bound by bytes, and the kernel reads both
halves once and writes h once, where torch ran silu and the product as two
passes over the strided halves (the design is in the source's note).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. Launches are counted in ``launch_counts()``."""

from __future__ import annotations

import array
import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import ATTENTION_DTYPE_CODES, _device_route, _refuse_grad


def swiglu_gate_reference(x12):
    """Plain version: ``F.silu(a) * b`` on the ``chunk(2, -1)`` halves, the
    SwiGLU block's composite."""
    a, b = x12.chunk(2, dim=-1)
    return F.silu(a) * b


def vector_instance(x12) -> bool:
    """True where the kernel's 16-byte vector instance reads x12: a row of
    h a whole number of 16-byte vectors and x12 16-byte aligned (the output,
    a fresh allocation, always is); else the general instance runs."""
    return (x12.shape[-1] // 2) * x12.element_size() % 16 == 0 and x12.data_ptr() % 16 == 0


def _launch(x12, out) -> None:
    """Launch the kernel on x12's device. The arguments cross to C as one
    int64 array (slots in csrc/swiglu_gate.cu)."""
    if x12.dtype not in ATTENTION_DTYPE_CODES:
        raise ValueError(f"swiglu_gate kernel takes float32, bfloat16 or float16, got {x12.dtype}")
    if not x12.is_contiguous():
        raise ValueError(f"swiglu_gate kernel: x12 must be contiguous, got strides {x12.stride()}")
    hidden = x12.shape[-1] // 2
    args = array.array("q", [x12.data_ptr(), out.data_ptr(), x12.numel() // (2 * hidden), hidden,
                             int(vector_instance(x12)), ATTENTION_DTYPE_CODES[x12.dtype], x12.device.index])
    stream = torch.cuda.current_stream(x12.device).cuda_stream
    # mdpt_swiglu_gate(the int64 argument array, stream)
    err = _build.kernel_entry("mdpt_swiglu_gate", ctypes.c_void_p, ctypes.c_void_p)(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"swiglu_gate kernel launch failed: CUDA error {err}")


def swiglu_gate(x12):
    """``silu(a) * b`` of the halves ``[a | b]`` of x12's last dim, a new
    contiguous (..., H) tensor in x12's dtype. Counts its launches as the
    route ``swiglu_gate``."""
    if x12.dim() < 1 or x12.shape[-1] < 2 or x12.shape[-1] % 2:
        raise ValueError(f"swiglu_gate: the last dim must be 2H, even and positive, got shape {tuple(x12.shape)}")
    if _device_route(x12.device, "swiglu_gate"):
        return swiglu_gate_reference(x12)
    _refuse_grad("swiglu_gate", x12)
    out = torch.empty((*x12.shape[:-1], x12.shape[-1] // 2), dtype=x12.dtype, device=x12.device)
    _launch(x12, out)
    _build.count("swiglu_gate")
    return out
