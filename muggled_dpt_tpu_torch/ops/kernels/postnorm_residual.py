"""SwinV2's post-norm residual: a hand-written CUDA kernel with its plain
PyTorch version beside it. The C entry is ``csrc/postnorm_residual.cu``.

``postnorm_residual(x, h, weight, bias, window_hw, shift_hw)`` returns
``x + LayerNorm(g(h))`` as a new contiguous (B, H, W, C) tensor in x's dtype:
x is a SwinV2 block's (B, H, W, C) residual stream and ``weight`` and
``bias`` its (C,) norm1 or norm2. With ``window_hw`` h is proj's (B, nW, A,
C) output in window order and g merges the windows and rolls the grid back
by ``shift_hw``, the inverse of the block's roll and partition; with no
window h is the MLP's (B, H, W, C) output and g the identity. The arithmetic
is the composite's: the statistics and the affine step in float32, the
LayerNorm rounded to x's dtype as ``F.layer_norm`` returns it, the add in
float32 rounded once; the kernel sums the statistics in another order. It
replaces no TPU kernel: the JAX package leaves the post-norm to XLA. On the
card it is bound by bytes, and the kernel reads h and x once and writes the
result once (the design is in the source's note).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. Launches are counted in ``launch_counts()``."""

from __future__ import annotations

import array
import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import ATTENTION_DTYPE_CODES, _device_route, _refuse_grad

EPS = 1e-5  # SwinV2's LayerNorm eps
MAX_ROW_BYTES = 32 * 12 * 16  # a row's channels in the kernel's widest group: 32 lanes of 12 16-byte vectors


def postnorm_residual_reference(x, h, weight, bias, window_hw=None, shift_hw=(0, 0)):
    """Plain version: ``x + layer_norm(roll(merge_windows(h)))``, the block's
    composite (no merge or roll with no window, no roll with no shift)."""
    b, gh, gw, c = x.shape
    if window_hw is not None:
        wh, ww = window_hw
        h = h.reshape(b, gh // wh, gw // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh, gw, c)
        if tuple(shift_hw) != (0, 0):
            h = torch.roll(h, shifts=tuple(shift_hw), dims=(1, 2))
    return x + F.layer_norm(h, (c,), weight, bias, EPS)


def _plan(x, h, weight, bias, window_hw, shift_hw):
    """((wh, ww), (sh, sw)) of the call, the grid itself as the window where
    h is in token order; raises ValueError where the shapes disagree."""
    if x.dim() != 4:
        raise ValueError(f"postnorm_residual: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, gh, gw, c = x.shape
    if window_hw is None:
        if tuple(shift_hw) != (0, 0):
            raise ValueError(f"postnorm_residual: a shift {tuple(shift_hw)} needs a window")
        if h.shape != x.shape:
            raise ValueError(f"postnorm_residual: h must be x's shape {tuple(x.shape)}, got {tuple(h.shape)}")
        window_hw = (gh, gw)
    else:
        wh, ww = window_hw
        if wh < 1 or ww < 1 or gh % wh or gw % ww:
            raise ValueError(f"postnorm_residual: window {tuple(window_hw)} does not tile the grid {(gh, gw)}")
        want = (b, (gh // wh) * (gw // ww), wh * ww, c)
        if tuple(h.shape) != want:
            raise ValueError(f"postnorm_residual: h must be (B, nW, A, C) = {want}, got {tuple(h.shape)}")
    sh, sw = shift_hw
    if not (0 <= sh < gh and 0 <= sw < gw):
        raise ValueError(f"postnorm_residual: shift {tuple(shift_hw)} outside the grid {(gh, gw)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"postnorm_residual: {name} must be (C,) = ({c},), got {tuple(t.shape)}")
    return tuple(window_hw), (sh, sw)


def _launch(x, h, weight, bias, window_hw, shift_hw, out) -> None:
    """Launch the kernel on x's device. The arguments cross to C as one
    int64 array (slots in csrc/postnorm_residual.cu)."""
    if x.dtype not in ATTENTION_DTYPE_CODES:
        raise ValueError(f"postnorm_residual kernel takes float32, bfloat16 or float16, got {x.dtype}")
    b, gh, gw, c = x.shape
    if c * x.element_size() % 16 or c * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"postnorm_residual kernel: a row of {c} channels must be a multiple of 16 bytes and at "
                         f"most {MAX_ROW_BYTES}")
    device = x.device
    for name, t in (("x", x), ("h", h), ("weight", weight), ("bias", bias)):
        if t.device != device or t.dtype != x.dtype:
            raise ValueError(f"postnorm_residual kernel: {name} is {t.dtype} on {t.device}, want {x.dtype} on {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"postnorm_residual kernel: {name} must be contiguous and 16-byte aligned, got strides "
                             f"{t.stride()} at address {t.data_ptr():#x}")
    (wh, ww), (sh, sw) = window_hw, shift_hw
    args = array.array("q", [x.data_ptr(), h.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b, gh, gw,
                             c, wh, ww, sh, sw, ATTENTION_DTYPE_CODES[x.dtype], device.index])
    stream = torch.cuda.current_stream(device).cuda_stream
    # mdpt_postnorm_residual(the int64 argument array, stream)
    err = _build.kernel_entry("mdpt_postnorm_residual", ctypes.c_void_p, ctypes.c_void_p)(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"postnorm_residual kernel launch failed: CUDA error {err}")


def postnorm_residual(x, h, weight, bias, window_hw=None, shift_hw=(0, 0)):
    """``x + LayerNorm(g(h))`` with eps 1e-5, a new contiguous (B, H, W, C)
    tensor in x's dtype; g merges h's windows of ``window_hw`` and rolls by
    ``shift_hw``, or is the identity with no window. Counts its launches as
    the route ``postnorm_residual``."""
    window, shift = _plan(x, h, weight, bias, window_hw, (0, 0) if shift_hw is None else shift_hw)
    if _device_route(x.device, "postnorm_residual"):
        return postnorm_residual_reference(x, h, weight, bias, window_hw, shift)
    _refuse_grad("postnorm_residual", x, h, weight, bias)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(x, h, weight, bias, window, shift, out)
    _build.count("postnorm_residual")
    return out
