"""Fused LayerNorm -> MLP -> LayerScale residual: a hand-written Hopper
kernel (``csrc/fused_mlp.cu``) with its plain PyTorch version beside it.

``fused_ln_mlp_residual(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls, eps)``
replaces ``experiments/pallas_fused_mlp.py:fused_ln_mlp_residual`` (TPU
kernel #8, ``_kernel``): ``x + ls * fc2(gelu(fc1(layer_norm(x))))``, the
second half of a pre-norm block with a GELU MLP (``models/dinov2.py``'s
``Block.mlp_residual``: Depth-Anything and BEiT). x is (..., F) in float32 or
bfloat16; the weights are in torch layout, fc1 (H, F) and fc2 (F, H), in x's
dtype. Rounding points, as the TPU kernel's: LayerNorm in float32 rounded to
x's dtype; fc1 summed in float32 plus its bias; exact GELU in float32
rounded to x's dtype; fc2 summed in float32 plus its bias, times ls, plus
the float32 residual; one rounding at the end.

Like the JAX package, the port serves its blocks through the unfused ops;
this kernel stands beside them and is held against ``Block.mlp_residual``.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. Launches are counted in
``fused_ln_mlp_residual.launches``, which ``flash_attention.launch_counts()``
reports as the route ``fused_mlp``."""

from __future__ import annotations

import array

import torch
import torch.nn.functional as F

from ._build import kernel_library
from .flash_attention import _DTYPE_CODES, _contiguous_pointer, _device_route

MAX_FEATURES = 1024  # the kernel's register accumulator covers F up to ViT-L's width
FEATURE_STEP = 64  # F must be a multiple: 8 warps x 8-column tiles
HIDDEN_STEP = 32  # H must be a multiple: the hidden slab


def _check_shapes(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls):
    f = x.shape[-1]
    hidden = fc1_w.shape[0] if fc1_w.dim() == 2 else -1
    want = {"ln_w": (f,), "ln_b": (f,), "fc1_w": (hidden, f), "fc1_b": (hidden,), "fc2_w": (f, hidden),
            "fc2_b": (f,), "ls": (f,)}
    for name, t in zip(want, (ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_ln_mlp_residual: {name} must be {want[name]} for x {tuple(x.shape)}, got {tuple(t.shape)}")


def fused_ln_mlp_residual_reference(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls, eps: float = 1e-6):
    """Plain version at the kernel's rounding points; returns x's shape and dtype."""
    dt = x.dtype
    xf = x.float()
    xn = F.layer_norm(xf, (xf.shape[-1],), ln_w.float(), ln_b.float(), eps).to(dt)
    g = F.gelu(F.linear(xn.float(), fc1_w.float(), fc1_b.float())).to(dt)
    y = F.linear(g.float(), fc2_w.float(), fc2_b.float())
    return (xf + ls.float() * y).to(dt)


def _launch(x, params, out, eps: float):
    """Launch the kernel on x's device: x and out (rows, F), params in the
    C entry's slot order. The arguments cross to C as one int64 array (slots
    in csrc/fused_mlp.cu)."""
    device, dtype = x.device, x.dtype
    dtype_code = _DTYPE_CODES.get(dtype)
    if dtype_code is None:
        raise ValueError(f"fused MLP kernel takes float32 or bfloat16, got {dtype}")
    f, hidden = x.shape[-1], params[2].shape[0]
    if f % FEATURE_STEP or not FEATURE_STEP <= f <= MAX_FEATURES or hidden % HIDDEN_STEP or hidden < HIDDEN_STEP:
        raise ValueError(f"fused MLP kernel: F must be a multiple of {FEATURE_STEP} up to {MAX_FEATURES} and H a "
                         f"multiple of {HIDDEN_STEP}, got F={f} H={hidden}")
    names = ("x", "ln_w", "ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ls", "out")  # weights stream in 16-byte chunks
    ptrs = [_contiguous_pointer("fused MLP", n, t, device, dtype, align=16) for n, t in zip(names, (x, *params, out))]
    rows = x.numel() // f
    args = array.array("q", [*ptrs, rows, f, hidden, dtype_code, device.index])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = kernel_library().mdpt_fused_mlp(args.buffer_info()[0], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused MLP kernel launch failed: CUDA error {err}")


def fused_ln_mlp_residual(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls, eps: float = 1e-6):
    """x + ls * fc2(gelu(fc1(layer_norm(x)))) over the last axis of x (any
    leading shape, at least one row). Returns a new tensor of x's shape and
    dtype. Counts its launches in ``fused_ln_mlp_residual.launches``."""
    params = (ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls)
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"fused_ln_mlp_residual needs at least one row, got x {tuple(x.shape)}")
    _check_shapes(x, *params)
    if _device_route(x.device, "fused_ln_mlp_residual"):
        return fused_ln_mlp_residual_reference(x, *params, eps=eps)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _launch(x, params, out, eps)
    fused_ln_mlp_residual.launches += 1
    return out


fused_ln_mlp_residual.launches = 0
