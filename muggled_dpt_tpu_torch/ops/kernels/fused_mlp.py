"""Fused LayerNorm -> MLP -> LayerScale residual: hand-written Hopper
kernels with their plain PyTorch version beside them. The C entry is
``csrc/fused_mlp.cu``; it sends every bfloat16 launch to the three kernels
of ``csrc/fused_mlp_sm90.cu`` (a LayerNorm pass into a bf16 scratch of the
normalized rows, then fc1 with bias and exact GELU in its epilogue and fc2
with bias, LayerScale and the residual in its epilogue, as wgmma/TMA GEMMs;
the (rows, H) GELU output goes through a second bf16 scratch), and float32
to ``mlp_f32`` of ``fused_mlp.cu`` (FMAs, the hidden activation on chip).

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
these kernels stand beside them and are held against ``Block.mlp_residual``.

A CPU tensor takes the plain version. A CUDA tensor launches the kernels or
raises; there is no fallback. The C entry reports the route it took, and
launches are counted per route, one per call whatever the number of device
kernels behind it: ``fused_ln_mlp_residual.sm90_launches`` (bfloat16,
``fused_mlp_sm90``) and ``fused_ln_mlp_residual.launches`` (float32,
``fused_mlp``), as ``flash_attention.launch_counts()`` reports them."""

from __future__ import annotations

import array

import torch
import torch.nn.functional as F

from ._build import kernel_library
from .flash_attention import _DTYPE_CODES, _contiguous_pointer, _device_route, _refuse_grad

MAX_FEATURES = 1024  # the f32 kernel's register accumulator and the bf16 LayerNorm pass's row hold F up to ViT-L's width
FEATURE_STEP = 64  # F must be a multiple: the f32 kernel's column split, the bf16 GEMMs' 64-wide K slabs of fc1
HIDDEN_STEP = 32  # H must be a multiple: the f32 kernel's hidden slab (16) and a 16-byte row of the bf16 scratch
SLOT_ROUTE = 17  # the argument array's last slot (enum Slot in csrc/fused_mlp.cu), written by the call
SM90_ROUTE = 1  # the value it holds when fused_mlp_sm90.cu ran


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


def _launch(x, params, out, eps: float, events=None) -> bool:
    """Launch the kernels on x's device: x and out (rows, F), params in the
    C entry's slot order. The arguments cross to C as one int64 array (slots
    in csrc/fused_mlp.cu), whose last slot the C entry fills with the route
    it took; a bfloat16 call gets its two scratch tensors here. ``events``:
    four ``torch.cuda.Event`` the sm_90 route records around its three
    kernels, or None. Returns True if that route ran."""
    device, dtype = x.device, x.dtype
    dtype_code = _DTYPE_CODES.get(dtype)
    if dtype_code is None:
        raise ValueError(f"fused MLP kernel takes float32 or bfloat16, got {dtype}")
    f, hidden = x.shape[-1], params[2].shape[0]
    if f % FEATURE_STEP or not FEATURE_STEP <= f <= MAX_FEATURES or hidden % HIDDEN_STEP or hidden < HIDDEN_STEP:
        raise ValueError(f"fused MLP kernel: F must be a multiple of {FEATURE_STEP} up to {MAX_FEATURES} and H a "
                         f"multiple of {HIDDEN_STEP}, got F={f} H={hidden}")
    names = ("x", "ln_w", "ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ls", "out")  # read by TMA or in 16-byte chunks
    ptrs = [_contiguous_pointer("fused MLP", n, t, device, dtype, align=16) for n, t in zip(names, (x, *params, out))]
    rows = x.numel() // f
    scratch = []  # bfloat16: the normalized rows and the GELU output, between the three kernels
    if dtype == torch.bfloat16:
        scratch = [torch.empty((rows, n), dtype=dtype, device=device) for n in (f, hidden)]
    handles = array.array("q", [e.cuda_event for e in events or ()])
    args = array.array("q", [*ptrs, rows, f, hidden, dtype_code, device.index,
                             *([t.data_ptr() for t in scratch] or [0, 0]), handles.buffer_info()[0] if events else 0, 0])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = kernel_library().mdpt_fused_mlp(args.buffer_info()[0], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused MLP kernel launch failed: CUDA error {err}")
    return args[SLOT_ROUTE] == SM90_ROUTE


def fused_ln_mlp_residual(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls, eps: float = 1e-6):
    """x + ls * fc2(gelu(fc1(layer_norm(x)))) over the last axis of x (any
    leading shape, at least one row). Returns a new tensor of x's shape and
    dtype. Counts its launches in ``fused_ln_mlp_residual.sm90_launches`` or
    ``.launches``, by the route the C entry took."""
    params = (ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls)
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"fused_ln_mlp_residual needs at least one row, got x {tuple(x.shape)}")
    _check_shapes(x, *params)
    if _device_route(x.device, "fused_ln_mlp_residual"):
        return fused_ln_mlp_residual_reference(x, *params, eps=eps)
    _refuse_grad("fused_ln_mlp_residual", x, *params)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if _launch(x, params, out, eps):
        fused_ln_mlp_residual.sm90_launches += 1
    else:
        fused_ln_mlp_residual.launches += 1
    return out


def sm90_stage_ms(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls, eps: float = 1e-6) -> tuple[float, float, float]:
    """Device milliseconds of the bfloat16 route's three kernels in one call
    (the LayerNorm pass, fc1, fc2), from CUDA events the C entry records
    between their launches. Counts as no launch of the wrapper's."""
    if x.dtype != torch.bfloat16 or x.device.type != "cuda":
        raise ValueError(f"sm90_stage_ms times the bfloat16 route on a CUDA card, got {x.dtype} on {x.device}")
    params = (ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls)
    _check_shapes(x, *params)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for e in events:  # a torch.cuda.Event makes its CUDA event at its first record
        e.record()
    if not _launch(x, params, torch.empty_like(x, memory_format=torch.contiguous_format), eps, events):
        raise RuntimeError("sm90_stage_ms: the C entry did not take the sm_90 route")
    events[-1].synchronize()
    return tuple(a.elapsed_time(b) for a, b in zip(events, events[1:]))


fused_ln_mlp_residual.launches = 0
fused_ln_mlp_residual.sm90_launches = 0
