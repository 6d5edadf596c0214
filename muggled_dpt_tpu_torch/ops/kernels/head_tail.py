"""Fused depth-head tail: hand-written Hopper kernels with their plain
PyTorch version beside them. The C entry is ``csrc/head_tail.cu``; it sends
every bfloat16 launch whose map a tensor map reads (a 16-byte aligned base,
W % 8 == 0, ci a multiple of 16 up to 192) to the implicit GEMM on wgmma
of ``csrc/head_tail_sm90.cu`` (M = 64 pixels of a row, N = 32 output
channels, K = 9 ci; the weights resident in shared memory, the input by
TMA with zero fill at the border, the projection and activation on
registers), and float32 and the other bfloat16 widths to the FMA kernel
``head_tail<T>`` of ``head_tail.cu``.

``fused_head_tail(x, conv_w, conv_b, proj_w, proj_b, is_metric)`` replaces
``experiments/pallas_head_conv.py:fused_head_tail`` (TPU kernel #9,
``_kernel``): the tail of a DPT head at full output resolution, 3x3 conv
(ci -> 32, zero padding 1) plus bias, ReLU, 1x1 conv (32 -> 1) plus bias,
then ReLU, or sigmoid for a metric head (``models/dpt_neck.py``'s
``Head.tail``). x is a contiguous NCHW (B, ci, H, W) map in float32 or
bfloat16; the weights are the ``Head``'s own, conv_w (32, ci, 3, 3) OIHW and
proj_w (1, 32, 1, 1), in x's dtype. The output is (B, H, W) in x's dtype,
summed in float32 and rounded once.

Like the JAX package, the port serves its heads through the unfused ops;
these kernels stand beside them and are held against ``Head.tail``.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. The C entry reports the kernel it ran, and
launches are counted per route: ``fused_head_tail.sm90_launches``
(``head_tail_sm90``) and ``fused_head_tail.launches`` (``head_tail``), as
``flash_attention.launch_counts()`` reports them."""

from __future__ import annotations

import array
import contextlib

import torch
import torch.nn.functional as F

from ._build import kernel_library
from .flash_attention import _DTYPE_CODES, MAX_GRID_YZ, _contiguous_pointer, _device_route, _refuse_grad

OUT_CHANNELS = 32  # every DPT head's last 3x3 conv
TILE = 16  # output tile side: the grid's y extent is ceil(H / 16)
SLOT_ROUTE = 14  # the argument array's last slot (enum Slot in csrc/head_tail.cu), written by the call
SM90_ROUTE = 1  # the value it holds when head_tail_sm90.cu ran


def _check_shapes(x, conv_w, conv_b, proj_w, proj_b):
    if x.dim() != 4:
        raise ValueError(f"fused_head_tail: x must be (B, ci, H, W), got {tuple(x.shape)}")
    ci = x.shape[1]
    want = {"conv_w": (OUT_CHANNELS, ci, 3, 3), "conv_b": (OUT_CHANNELS,), "proj_w": (1, OUT_CHANNELS, 1, 1), "proj_b": (1,)}
    for name, t in zip(want, (conv_w, conv_b, proj_w, proj_b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_head_tail: {name} must be {want[name]} for x {tuple(x.shape)}, got {tuple(t.shape)}")


@contextlib.contextmanager
def _true_float32():
    """cuDNN convolutions in full float32 (they default to TF32 on the card)."""
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allowed


def fused_head_tail_reference(x, conv_w, conv_b, proj_w, proj_b, is_metric: bool = False):
    """Plain version: both convs in float32, one rounding to x's dtype. Returns (B, H, W)."""
    with _true_float32():
        t = torch.relu(F.conv2d(x.float(), conv_w.float(), conv_b.float(), padding=1))
        y = F.conv2d(t, proj_w.float(), proj_b.float())
    y = torch.sigmoid(y) if is_metric else torch.relu(y)
    return y[:, 0].to(x.dtype)


def _launch(x, params, out, is_metric: bool) -> bool:
    """Launch the kernel on x's device; params in the C entry's slot order.
    The arguments cross to C as one int64 array (slots in csrc/head_tail.cu),
    whose last slot the C entry fills with the route it took. Returns True
    if that was the sm_90 kernel."""
    device, dtype = x.device, x.dtype
    dtype_code = _DTYPE_CODES.get(dtype)
    if dtype_code is None:
        raise ValueError(f"head tail kernel takes float32 or bfloat16, got {dtype}")
    b, ci, h, w = x.shape
    if min(b, ci, h, w) < 1 or b > MAX_GRID_YZ or -(-h // TILE) > MAX_GRID_YZ:
        raise ValueError(f"head tail kernel: bad grid batch={b} channels={ci} height={h} width={w}")
    names = ("x", "conv_w", "conv_b", "proj_w", "proj_b", "out")
    ptrs = [_contiguous_pointer("head tail", n, t, device, dtype) for n, t in zip(names, (x, *params, out))]
    args = array.array("q", [*ptrs, b, ci, h, w, OUT_CHANNELS, int(bool(is_metric)), dtype_code, device.index, 0])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = kernel_library().mdpt_head_tail(args.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"head tail kernel launch failed: CUDA error {err}")
    return args[SLOT_ROUTE] == SM90_ROUTE


def fused_head_tail(x, conv_w, conv_b, proj_w, proj_b, is_metric: bool = False):
    """relu(conv3x3(x) + conv_b) -> 1x1 projection + proj_b -> ReLU or
    sigmoid, on a contiguous (B, ci, H, W) map; returns (B, H, W). Counts its
    launches in ``fused_head_tail.sm90_launches`` or ``.launches``, by the
    route the C entry took."""
    params = (conv_w, conv_b, proj_w, proj_b)
    _check_shapes(x, *params)
    if _device_route(x.device, "fused_head_tail"):
        return fused_head_tail_reference(x, *params, is_metric=is_metric)
    _refuse_grad("fused_head_tail", x, *params)
    out = torch.empty((x.shape[0], x.shape[2], x.shape[3]), dtype=x.dtype, device=x.device)
    if _launch(x, params, out, is_metric):
        fused_head_tail.sm90_launches += 1
    else:
        fused_head_tail.launches += 1
    return out


fused_head_tail.launches = 0
fused_head_tail.sm90_launches = 0
