"""Image resampling with ``F.interpolate``, in the four configurations the
ported paths use:

* bilinear, align_corners=False, antialias=True  -- image preprocessing
* bicubic,  align_corners=False, antialias=False -- position-embedding resize
* bilinear, align_corners=True                   -- fusion and head upsampling
  (on the card the neck runs ``ops/kernels/upsample.py``, bit for bit the same)
* bilinear, align_corners=False, antialias=False -- BEiT relative-position LUT

The JAX package rebuilds these as dense or banded weight matrices for the
TPU's matrix unit; here torch's own interpolation is the reference they were
built to match. Bicubic, antialiased and plain bilinear resizes are computed
in float32, as there; the align-corners bilinear upsample runs in the
input's dtype."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize_2d(x: torch.Tensor, out_hw, align_corners: bool = False, antialias: bool = False):
    """Bilinear resize of an NCHW float tensor to ``out_hw`` = (H, W): with
    align_corners=False, antialiased or not, computed in float32; with
    align_corners=True (never antialiased), in the input's dtype."""
    if align_corners and antialias:
        raise ValueError(f"unsupported bilinear resize: align_corners={align_corners} antialias={antialias}")
    x_in = x if align_corners else x.float()
    y = F.interpolate(x_in, size=tuple(int(s) for s in out_hw), mode="bilinear", align_corners=align_corners, antialias=antialias)
    return y.to(x.dtype)


def resize_bicubic_hwc(grid: torch.Tensor, out_hw) -> torch.Tensor:
    """Bicubic resize (align_corners=False, no antialias) of an (H, W, C)
    grid to (out_h, out_w, C), computed in float32, returned in the input's dtype.

    It runs as two separable passes, each a 2-D ``F.interpolate`` over a view
    whose second axis keeps its size (at a scale of exactly 1 the bicubic
    taps are 0, 1, 0, 0, so that axis passes through unchanged). torch's CUDA
    bicubic kernel has one thread per output pixel looping over every
    channel: on the (1, 1024, 37, 37) pos-embed that one call took 9.3 ms on
    an H100 (700 W). The views put the channels in the width axis instead."""
    h, w, c = grid.shape
    th, tw = (int(s) for s in out_hw)
    x = grid.float().reshape(1, 1, h, w * c)
    x = F.interpolate(x, size=(th, w * c), mode="bicubic", align_corners=False)  # rows
    x = F.interpolate(x.reshape(1, th, w, c), size=(tw, c), mode="bicubic", align_corners=False)  # columns
    return x.reshape(th, tw, c).to(grid.dtype)


def resize_output_size(in_hw, scale_factor: float) -> tuple[int, int]:
    """torch's output-size rule for interpolate(scale_factor=s): floor(in * s)."""
    return (int(math.floor(in_hw[0] * scale_factor)), int(math.floor(in_hw[1] * scale_factor)))
