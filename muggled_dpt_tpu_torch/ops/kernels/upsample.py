"""Bilinear align_corners=True upsample: a hand-written CUDA kernel with its
plain PyTorch version beside it. The C entry is ``csrc/upsample_bilinear_ac.cu``.

``upsample_bilinear_ac(x, out_hw)`` resizes a (B, C, H, W) map in float32,
bfloat16 or float16 to (B, C, *out_hw), as ``F.interpolate(x, out_hw,
mode="bilinear", align_corners=True)`` does, in the same float32 arithmetic,
rounded once to x's dtype. It is the DPT neck's upsample
(``models/dpt_neck.py``: ``FusionBlock`` and ``Head``). It replaces no TPU
kernel: the JAX package computes this resize as banded matrix products on the
MXU (``muggled_dpt_tpu/ops/resize.py:_apply_linear_bf16``); on the card it is
bound by bytes, and the kernel moves each about once (the design is in the
source's note).

x is read in place, in either of the two dense memory formats, never copied:
channels-last (the reassembly maps start out so, and cuDNN keeps them so) or
NCHW-contiguous. Any other layout raises. The output is a new tensor in the
memory format ``F.interpolate`` gives it (``torch``'s
``suggest_memory_format``), so the convolutions after it see the layout they
would see after ``F.interpolate``.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. Launches are counted per memory format in
``launch_counts()``."""

from __future__ import annotations

import array
import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import ATTENTION_DTYPE_CODES, MAX_GRID_YZ, _device_route, _refuse_grad

LAYOUT_NCHW, LAYOUT_CHANNELS_LAST = 0, 1  # csrc/upsample_bilinear_ac.cu's SLOT_LAYOUT values


def _strides_like_channels_last(x: torch.Tensor) -> bool:
    """Whether torch takes x's strides for channels-last
    (``c10::is_channels_last_strides_2d_s4``, behind ``suggest_memory_format``):
    the order C, W, H, B of increasing strides, ambiguous cases NCHW."""
    sizes, strides = x.shape, x.stride()
    if strides[1] == 0:
        return False
    least = 0
    for d in (1, 3, 2, 0):
        if sizes[d] == 0 or strides[d] < least or (d == 0 and least == strides[1]):
            return False
        least = strides[d] * max(sizes[d], 1)
    return True


def _layout(x: torch.Tensor) -> int:
    """x's memory format as the kernel reads it; raises on a rank, dtype or
    layout the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"upsample_bilinear_ac: x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in ATTENTION_DTYPE_CODES:
        raise ValueError(f"upsample_bilinear_ac takes float32, bfloat16 or float16, got {x.dtype}")
    if _strides_like_channels_last(x) and x.is_contiguous(memory_format=torch.channels_last):
        return LAYOUT_CHANNELS_LAST
    if x.is_contiguous():
        return LAYOUT_NCHW
    raise ValueError(f"upsample_bilinear_ac: x must be channels-last or NCHW-contiguous, got strides {x.stride()} "
                     f"for {tuple(x.shape)}")


def _output_size(out_hw) -> tuple[int, int]:
    ho, wo = (int(s) for s in out_hw)
    if ho < 1 or wo < 1:
        raise ValueError(f"upsample_bilinear_ac: bad output size {(ho, wo)}")
    return ho, wo


def empty_output(x: torch.Tensor, out_hw, layout: int | None = None) -> torch.Tensor:
    """The (B, C, *out_hw) output, uninitialized, in x's memory format
    (``layout``, or read from x)."""
    layout = _layout(x) if layout is None else layout
    fmt = torch.channels_last if layout == LAYOUT_CHANNELS_LAST else torch.contiguous_format
    return torch.empty((*x.shape[:2], *_output_size(out_hw)), dtype=x.dtype, device=x.device, memory_format=fmt)


def upsample_bilinear_ac_reference(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Plain version: ``F.interpolate``, bilinear, align_corners=True."""
    return F.interpolate(x, size=_output_size(out_hw), mode="bilinear", align_corners=True)


def _launch(x: torch.Tensor, out: torch.Tensor, layout: int) -> None:
    """Launch the kernel on x's device. The arguments cross to C as one
    int64 array (slots in csrc/upsample_bilinear_ac.cu)."""
    b, c, h, w = x.shape
    ho, wo = out.shape[-2:]
    if b > MAX_GRID_YZ or ho > MAX_GRID_YZ:
        raise ValueError(f"upsample_bilinear_ac kernel: bad grid batch={b} out height={ho}")
    device = x.device
    args = array.array("q", [x.data_ptr(), *x.stride(), out.data_ptr(), b, c, h, w, ho, wo, layout,
                             ATTENTION_DTYPE_CODES[x.dtype], device.index])
    stream = torch.cuda.current_stream(device).cuda_stream
    # mdpt_upsample_bilinear_ac(the int64 argument array, stream)
    entry = _build.kernel_entry("mdpt_upsample_bilinear_ac", ctypes.c_void_p, ctypes.c_void_p)
    err = entry(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"upsample_bilinear_ac kernel launch failed: CUDA error {err}")


def upsample_bilinear_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear align_corners=True resize of a (B, C, H, W) map to ``out_hw``
    = (HO, WO), returned in x's dtype and memory format. Counts its launches
    as the route ``upsample_ac`` (channels-last) or ``upsample_ac_nchw``."""
    layout = _layout(x)
    if _device_route(x.device, "upsample_bilinear_ac"):
        return upsample_bilinear_ac_reference(x, out_hw)
    _refuse_grad("upsample_bilinear_ac", x)
    out = empty_output(x, out_hw, layout)
    _launch(x, out, layout)
    _build.count("upsample_ac" if layout == LAYOUT_CHANNELS_LAST else "upsample_ac_nchw")
    return out

