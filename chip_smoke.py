#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU, through its
hand-written attention kernels, and check what comes out.

    python3 chip_smoke.py

Models, each at full width with random weights from a seed, written as an
original-format checkpoint and loaded through ``make_dpt_from_state_dict``:
  * Depth-Anything V2 ViT-L (F=1024, 24 blocks, 16 heads x 64, patch 14):
    a 720x1280 BGR frame at max side 518 snaps to 504x504 (1297 tokens);
  * MiDaS v3.1 BEiT-L-512 (F=1024, 24 blocks, 16 heads x 64, patch 16,
    relative-position bias in every block): max side 512 gives 512x512
    (1025 tokens), max side 1024 gives 1024x1024 (4097 tokens);
  * MiDaS v3.1 SwinV2-L-384 (F=192/384/768/1536, 2/2/18/2 blocks, 6/12/24/48
    heads x 32, patch 4, window 24): max side 384 gives 384x384, whose 24
    window attentions run at (nW, A, H) = (16, 576, 6) with the shift mask
    on odd blocks, (4, 576, 12) likewise, (1, 576, 24) and (1, 144, 48);
    max side 512 gives 512x512, where the window search picks 32 (A=1024)
    at stages 1-3 and 16 at stage 4.

Two CUDA kernels port five TPU kernels; the ``kernels`` JSON line has one
entry per TPU kernel:
  #1 fused qkv, unbiased  -- the Depth-Anything path;
  #2 fused qkv, biased    -- the BEiT path (cached bias stack or inline bias);
  #3 window attention     -- the SwinV2 path (csrc/window_attention.cu; the
     CPB bias and shift mask read factored, by head and by window);
  #4 / #5 (B, N, H, D) op -- the JAX package reaches it through its
     ``flash_attention`` op (the drop-in for dot_product_attention); no model
     of the port calls it, since the port serves every BEiT grid through #2.
     Its path is that op, driven at BEiT-L-512's attention shape (#4) and
     past 32768 keys (#5, the online kernel's regime).

Phases, in order; each prints its lines and the seconds it took, and any
failure raises:
  1. device: a CUDA card, or fail; the nvidia-smi name and power limit;
  2. build: nvcc builds the kernel library from csrc/, one nvcc per source,
     all started together;
  3. each kernel vs its plain version at the paths' shapes and edge cases,
     float32 and bfloat16, then CUDA-event times of both, in turns (the
     window kernel at each SwinV2-L-384 stage shape, B=1 and B=8);
  4. DA-V2 bf16 serves 3 requests and a batch of 8 (24 launches per forward);
  5. DA-V2 float32 kernel model vs float32 plain model;
  6. BEiT-L-512 bf16 serves 3 requests and a batch of 8 at 512x512 (24
     biased launches per forward) and one 1024x1024 request through the
     cached bias stack;
  7. BEiT-L-512 float32 kernel model vs plain model, cached and inline bias;
  8. SwinV2-L-384 bf16 serves 3 requests and a batch of 8 at 384x384 (24
     window launches per forward) and one 512x512 request, its CPB stack
     build included;
  9. SwinV2-L-384 float32 kernel model vs plain model, cached and inline
     CPB and masks;
  10. the (B, N, H, D) op path.
Then one JSON line of per-kernel results, the card line, and last the ok line.

Imports only torch, numpy and the port: never jax or the JAX package."""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as random_beit_state_dict
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2_state_dict
from muggled_dpt_tpu_torch.make_dpt import make_dpt_from_state_dict
from muggled_dpt_tpu_torch.models.swinv2 import shift_mask, stage_grids, window_plan
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa

VITL = {
    "features_per_token": 1024,
    "num_blocks": 24,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 14,
    "base_patch_grid_hw": (37, 37),
}
BEIT_L512 = {  # MiDaS v3.1 dpt_beit_large_512
    "features_per_token": 1024,
    "num_blocks": 24,
    "num_heads": 16,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 16,
    "base_patch_grid_hw": (32, 32),
}
SWIN_L384 = {  # MiDaS v3.1 dpt_swin2_large_384
    "features_per_stage": [192, 384, 768, 1536],
    "heads_per_stage": [6, 12, 24, 48],
    "layers_per_stage": [2, 2, 18, 2],
    "base_patch_grid_hw": (96, 96),
    "window_size_hw": (24, 24),
    "pretrained_window_sizes_per_stage": [12, 12, 12, 6],
    "fusion_channels": 256,
    "patch_size_px": 4,
}
SWIN_SIDE, SWIN_HW, SWIN_BIG_SIDE = 384, (384, 384), 512
SWIN_BLOCKS = sum(SWIN_L384["layers_per_stage"])  # 24 window attentions per forward
SWIN_D = 32
# (windows, window, heads, shift mask) of each stage at 384x384
SWIN_STAGES = [(16, (24, 24), 6, True), (4, (24, 24), 12, True), (1, (24, 24), 24, False), (1, (12, 12), 48, False)]
HEADS, HEAD_DIM = 16, 64
FRAME_HW = (720, 1280)
MAX_SIDE, OUT_HW = 518, (504, 504)
N_TOKENS = 1 + (OUT_HW[0] // 14) * (OUT_HW[1] // 14)  # 1297
BEIT_SIDE, BEIT_HW, BEIT_BIG_SIDE = 512, (512, 512), 1024
N_BEIT = 1 + (512 // 16) ** 2  # 1025
N_ONLINE = 32897  # past the JAX package's 32768-key one-pass ceiling
SEED = 0
DEVICE = "cuda"

# tolerances of the kernel against its plain version on the same inputs
F32_MAX_ERR = 1e-4  # f32 FMAs in another summation order
BF16_MAX_ERR, BF16_MEAN_ERR = 2e-2, 2e-3  # p rounded to bf16 before PV, bf16 output
ABS_REL_BUDGET = 1e-3  # whole-model f32 budget of the repo

REPLACES = {
    1: "muggled_dpt_tpu/ops/pallas/flash_attention.py:125",
    2: "muggled_dpt_tpu/ops/pallas/flash_attention.py:434",
    3: "muggled_dpt_tpu/ops/pallas/window_attention.py:31",
    4: "muggled_dpt_tpu/ops/pallas/flash_attention.py:86",
    5: "muggled_dpt_tpu/ops/pallas/flash_attention.py:497",
}
NAMES = {
    1: "flash_attention_fused_qkv",
    2: "flash_attention_fused_qkv (bias, bias_stack + layer)",
    3: "window_attention (factored CPB bias + shift mask)",
    4: "flash_attention (B, N, H, D)",
    5: "flash_attention (B, N, H, D), past 32768 keys",
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = card_line()
    print(smi, flush=True)
    return smi


def phase_build():
    from muggled_dpt_tpu_torch.ops.kernels._build import build_library, kernel_library

    path = build_library(verbose=True)
    kernel_library()
    print(f"build: {path.name}", flush=True)


def make_qkv(rng, b, n, dtype, all_negative=False):
    """Head-major (B, N, 3C) qkv on the card, drawn with numpy. all_negative
    makes every logit strongly negative: q = -8|x|, k = |y|."""
    heads = HEADS
    x = rng.standard_normal((b, n, heads, 3, HEAD_DIM), dtype=np.float32)
    if all_negative:
        x[..., 0, :] = -8.0 * np.abs(x[..., 0, :])
        x[..., 1, :] = np.abs(x[..., 1, :])
    return torch.from_numpy(x.reshape(b, n, 3 * heads * HEAD_DIM)).to(DEVICE, dtype)


def make_bias(rng, shape, dtype, scale=1.0, shift=0.0):
    x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)
    return torch.from_numpy(x).to(DEVICE, dtype)


def padded_stack(rng, layers, n, dtype):
    """A (L, H, Np, Np) bias stack, Np = N rounded up to 8 (the cached
    stack's layout), with 1e6 in every pad: the kernel must never read it."""
    n_pad = (n + 7) // 8 * 8
    stack = make_bias(rng, (layers, HEADS, n_pad, n_pad), dtype)
    stack[..., n:, :] = 1e6
    stack[..., :, n:] = 1e6
    return stack


def time_ms(fn, iters=30, warmup=5) -> float:
    """Median of per-launch CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Checker:
    """Holds each kernel against its plain version and keeps each TPU
    kernel's worst error."""

    def __init__(self):
        self.worst = {1: 0.0, 2: 0.0, 3: 0.0, 4: 0.0, 5: 0.0}

    def __call__(self, kid, label, got, ref, shape):
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        err = (got - ref).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        ok = bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(shape)
        if label.startswith("float32"):
            ok = ok and max_err <= F32_MAX_ERR
        else:
            ok = ok and max_err <= BF16_MAX_ERR and mean_err <= BF16_MEAN_ERR
        print(f"kernel check #{kid} {label}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e}", flush=True)
        if not ok:
            raise RuntimeError(f"kernel #{kid} disagrees with its plain version at {label}")
        self.worst[kid] = max(self.worst[kid], max_err)


def make_windows(rng, b, nw, window_hw, h, dtype, bias_dtype, with_mask, views=False):
    """Window attention inputs as the SwinV2 block hands them over, drawn
    with numpy: q l2-normalized times a logit scale of 10, k l2-normalized,
    v N(0, 1) clipped to +-3.5, each (B, nW, A, H, 32), A = the window's
    area (``views``: strided views of one (B, nW, A, 3, H, 32) qkv); cpb =
    16 * sigmoid(N(0, 1)) (H, A, A); the (nW, A, A) shift mask of a square
    grid of nW windows rolled by half a window, as the model builds it.
    An output is a convex combination of v's rows, so the clip keeps it
    below 4, where one bf16 ulp (1.6e-2) fits the bf16 gate; at [4, 8) one
    ulp is 3.1e-2, which the kernel, rounding p before normalizing, may
    differ by."""
    a = window_hw[0] * window_hw[1]
    qkv = torch.from_numpy(rng.standard_normal((b, nw, a, 3, h, SWIN_D), dtype=np.float32)).to(DEVICE)
    qkv[:, :, :, 2].clamp_(-3.5, 3.5)
    norm = torch.rsqrt((qkv[:, :, :, :2] ** 2).sum(-1, keepdim=True) + 1e-12)
    qkv[:, :, :, :2] *= norm
    qkv[:, :, :, 0] *= 10.0
    qkv = qkv.to(dtype)
    q, k, v = qkv.unbind(3) if views else (t.contiguous() for t in qkv.unbind(3))
    cpb = (16.0 * torch.sigmoid(torch.from_numpy(rng.standard_normal((h, a, a), dtype=np.float32)))).to(DEVICE, bias_dtype)
    mask = None
    if with_mask:
        side = math.isqrt(nw)
        grid = (side * window_hw[0], side * window_hw[1])
        mask = shift_mask(grid, window_hw, (window_hw[0] // 2, window_hw[1] // 2), DEVICE, bias_dtype)
    return q, k, v, cpb, mask


def check_windows(check, rng, dtype, b, nw, window_hw, h, with_mask, bias_dtype=None, views=False):
    bias_dtype = bias_dtype or dtype
    args = make_windows(rng, b, nw, window_hw, h, dtype, bias_dtype, with_mask, views)
    a = window_hw[0] * window_hw[1]
    label = (f"{str(dtype)[6:]} B={b} nW={nw} A={a} H={h}{' mask' if with_mask else ''} bias {str(bias_dtype)[6:]}"
             f"{' strided views of one qkv' if views else ''}")
    check(3, label, wa.window_attention(*args), wa.window_attention_reference(*args), (b, nw, a, h, SWIN_D))


def _split(qkv):
    x = qkv.unflatten(2, (HEADS, 3, HEAD_DIM))
    return x[..., 0, :], x[..., 1, :], x[..., 2, :]


def phase_kernel(smi: str) -> dict:
    """Kernel vs plain version, then times. Returns {kernel id: numbers}."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true f32
    rng = np.random.default_rng(SEED)
    check = Checker()
    device_before = torch.cuda.current_device()
    layers = BEIT_L512["num_blocks"]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        # #1: unbiased fused, the DA shapes and edge cases
        for b, n, neg, scale in [(1, N_TOKENS, False, None), (8, N_TOKENS, False, None), (1, 1, False, None),
                                 (1, 63, False, None), (1, 65, False, None), (2, 200, False, None),
                                 (2, 200, False, 0.3), (2, 200, True, None), (1, N_TOKENS, True, None)]:
            qkv = make_qkv(rng, b, n, dtype, neg)
            label = f"{name} B={b} N={n}{' all-negative' if neg else ''}{f' scale={scale}' if scale else ''}"
            got = fa.flash_attention_fused_qkv(qkv, HEADS, scale=scale)
            check(1, label, got, fa.flash_attention_fused_qkv_reference(qkv, HEADS, scale=scale), (b, n, HEADS * HEAD_DIM))
        # #2: biased fused at BEiT-L-512's N, every bias source
        n = N_BEIT
        stack = padded_stack(rng, layers, n, dtype)
        for b in (1, 8):
            qkv = make_qkv(rng, b, n, dtype)
            sources = {
                "(1,H,N,N)": {"bias": make_bias(rng, (1, HEADS, n, n), dtype)},
                "(B,H,N,N)": {"bias": make_bias(rng, (b, HEADS, n, n), dtype)},
                "(1,1,1,N)": {"bias": make_bias(rng, (1, 1, 1, n), dtype, scale=4.0)},
                "(1,1,N,1)": {"bias": make_bias(rng, (1, 1, n, 1), dtype, scale=4.0)},
                f"(1,H,N,N) {str(other)[6:]}": {"bias": make_bias(rng, (1, HEADS, n, n), other)},
                "stack layer 0, pads 1e6": {"bias_stack": stack, "layer": 0},
                f"stack layer 1 {str(other)[6:]}, pads 1e6": {"bias_stack": padded_stack(rng, 2, n, other), "layer": 1},
                f"stack layer {layers - 1}, pads 1e6": {"bias_stack": stack, "layer": layers - 1},
            }
            for src, kw in sources.items():
                got = fa.flash_attention_fused_qkv(qkv, HEADS, **kw)
                ref = fa.flash_attention_fused_qkv_reference(qkv, HEADS, **kw)
                check(2, f"{name} B={b} N={n} bias {src}", got, ref, (b, n, HEADS * HEAD_DIM))
        del stack
        for n in (1, 63, 65, 577, 4097):
            qkv, bias = make_qkv(rng, 1, n, dtype), make_bias(rng, (1, HEADS, n, n), dtype)
            got = fa.flash_attention_fused_qkv(qkv, HEADS, bias=bias)
            check(2, f"{name} B=1 N={n} bias (1,H,N,N)", got, fa.flash_attention_fused_qkv_reference(qkv, HEADS, bias=bias),
                  (1, n, HEADS * HEAD_DIM))
        qkv, bias = make_qkv(rng, 2, N_BEIT, dtype, all_negative=True), make_bias(rng, (1, HEADS, N_BEIT, N_BEIT), dtype, 0.1, -50.0)
        got = fa.flash_attention_fused_qkv(qkv, HEADS, bias=bias)
        check(2, f"{name} B=2 N={N_BEIT} all-negative, bias ~ -50", got,
              fa.flash_attention_fused_qkv_reference(qkv, HEADS, bias=bias), (2, N_BEIT, HEADS * HEAD_DIM))
        # #4: the (B, N, H, D) entry, contiguous and strided views of one qkv
        for b in (1, 8):
            qkv = make_qkv(rng, b, N_BEIT, dtype)
            bias = make_bias(rng, (1, HEADS, N_BEIT, N_BEIT), dtype)
            views = {"strided views of one qkv": _split(qkv), "contiguous": tuple(t.contiguous() for t in _split(qkv))}
            for kind, (q, k, v) in views.items():
                for bias_kw in ({}, {"bias": bias}):
                    got = fa.flash_attention(q, k, v, **bias_kw)
                    ref = fa.flash_attention_reference(q, k, v, **bias_kw)
                    label = f"{name} B={b} N={N_BEIT} {kind}{' bias (1,H,N,N)' if bias_kw else ''}"
                    check(4, label, got, ref, (b, N_BEIT, HEADS, HEAD_DIM))
        # #5: unbiased past 32768 keys
        q, k, v = (make_bias(rng, (1, N_ONLINE, 2, HEAD_DIM), dtype) for _ in range(3))
        check(5, f"{name} B=1 N={N_ONLINE} H=2", fa.flash_attention(q, k, v), fa.flash_attention_reference(q, k, v),
              (1, N_ONLINE, 2, HEAD_DIM))
        del q, k, v
        # #3: the SwinV2-L-384 stage shapes, the 512x512 ones (A=1024), the
        # divisor search's largest window (A=2209), ragged and odd areas,
        # strided views, a bias in the other dtype
        for b in (1, 8):
            for nw, window_hw, h, with_mask in SWIN_STAGES:
                check_windows(check, rng, dtype, b, nw, window_hw, h, with_mask)
        for nw, h in ((16, 6), (4, 12)):
            check_windows(check, rng, dtype, 1, nw, (32, 32), h, True)
        check_windows(check, rng, dtype, 1, 1, (47, 47), 2, False)
        for window_hw in ((4, 4), (5, 5), (6, 6), (10, 15)):  # A = 16, 25, 36, 150
            check_windows(check, rng, dtype, 2, 4, window_hw, 3, True)
        check_windows(check, rng, dtype, 2, 4, (24, 24), 3, True, views=True)
        check_windows(check, rng, dtype, 2, 4, (10, 15), 3, True, bias_dtype=other)
        torch.cuda.empty_cache()
    if torch.cuda.current_device() != device_before:
        raise RuntimeError("a kernel launch changed the current CUDA device")
    print(f"current device unchanged by the launches: cuda:{device_before}", flush=True)

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        stack = padded_stack(rng, layers, N_BEIT, dtype)
        for b in (1, 8):
            qkv_da, qkv = make_qkv(rng, b, N_TOKENS, dtype), make_qkv(rng, b, N_BEIT, dtype)
            q, k, v = _split(qkv)
            bias = stack[layers - 1][None]  # a (1, H, Np, Np) layer of the padded stack, as BEiT hands it over
            last = {"bias_stack": stack, "layer": layers - 1}
            pairs = {
                (1, f"fused N={N_TOKENS}"): (lambda: fa.flash_attention_fused_qkv(qkv_da, HEADS),
                                             lambda: fa.flash_attention_fused_qkv_reference(qkv_da, HEADS)),
                (2, f"fused N={N_BEIT} stack layer {layers - 1}"): (
                    lambda: fa.flash_attention_fused_qkv(qkv, HEADS, **last),
                    lambda: fa.flash_attention_fused_qkv_reference(qkv, HEADS, **last)),
                (4, f"(B,N,H,D) views N={N_BEIT} bias (1,H,Np,Np) stack layer"): (
                    lambda: fa.flash_attention(q, k, v, bias=bias), lambda: fa.flash_attention_reference(q, k, v, bias=bias)),
            }
            for (kid, what), (kernel, plain) in pairs.items():
                p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)  # in turns
                times[(kid, dtype, b)] = (min(k1, k2), min(p1, p2))
                print(f"kernel time #{kid} {name} B={b} {what} H={HEADS} D={HEAD_DIM}: "
                      f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms [{smi}]", flush=True)
        del stack
        q, k, v = (make_bias(rng, (1, N_ONLINE, 2, HEAD_DIM), dtype) for _ in range(3))
        kernel, plain = (lambda: fa.flash_attention(q, k, v)), (lambda: fa.flash_attention_reference(q, k, v))
        p1, k1, k2, p2 = (time_ms(f, iters=5, warmup=1) for f in (plain, kernel, kernel, plain))
        times[(5, dtype, 1)] = (min(k1, k2), min(p1, p2))
        print(f"kernel time #5 {name} B=1 N={N_ONLINE} H=2 D={HEAD_DIM}: "
              f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms [{smi}]", flush=True)
        del q, k, v
        # #3 at each SwinV2-L-384 stage shape, the bias in the model's dtype
        for b in (1, 8):
            for s, (nw, window_hw, h, with_mask) in enumerate(SWIN_STAGES, start=1):
                a = window_hw[0] * window_hw[1]
                args = make_windows(rng, b, nw, window_hw, h, dtype, dtype, with_mask, views=True)
                kernel, plain = (lambda: wa.window_attention(*args)), (lambda: wa.window_attention_reference(*args))
                p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)  # in turns
                times[(3, dtype, b, s)] = (min(k1, k2), min(p1, p2))
                print(f"kernel time #3 {name} B={b} stage {s} nW={nw} A={a} H={h} D={SWIN_D}{' mask' if with_mask else ''}: "
                      f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms [{smi}]", flush=True)
        torch.cuda.empty_cache()
    # the JSON line carries the bf16 serving shape of each kernel (#3: stage 1, the most windows)
    at = {1: (8,), 2: (8,), 3: (8, 1), 4: (8,), 5: (1,)}
    return {kid: {"max_abs_err": check.worst[kid], "ms": times[(kid, torch.bfloat16, *key)][0],
                  "plain_ms": times[(kid, torch.bfloat16, *key)][1]} for kid, key in at.items()}


def _abs_rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    return float((ours.float() - ref.float()).abs().mean() / (ref.float().abs().mean() + 1e-12))


def _check_depth(depth, shape, what):
    if tuple(depth.shape) != shape or not bool(torch.isfinite(depth).all()):
        raise RuntimeError(f"{what}: got shape {tuple(depth.shape)} (want {shape}), finite={bool(torch.isfinite(depth).all())}")


def _host_ms(fn, iters=10, warmup=3) -> float:
    """Median host-clock time of fn (which ends in a synchronize), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _counted(fn, route, want, what):
    """Run fn, require exactly `want` launches on `route` and none on the others."""
    before = fa.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = fa.launch_counts()
    delta = {r: after[r] - before[r] for r in after}
    if delta != {r: (want if r == route else 0) for r in delta}:
        raise RuntimeError(f"{what}: launches {delta}, want {want} on route {route!r} only")
    return out


def serve(smi, model, side, out_hw, route, blocks, what) -> torch.Tensor:
    """bf16 serving through the public entry points: 3 requests through
    ``inference`` and one batch of 8 frames through ``inference_rgb_device``.
    Returns the first request's depth."""
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(6)]
    first = None
    for i in range(3):
        depth = _counted(lambda: model.inference(frames[i], side), route, blocks, f"{what} request {i}")
        _check_depth(depth, (1, *out_hw), f"{what} request {i}")
        first = depth if first is None else first
    hw = model.compute_scaled_hw(FRAME_HW, side)
    stack = torch.from_numpy(np.stack(frames + [frames[0], frames[3]])).to(DEVICE)  # rows 6, 7 repeat rows 0, 3
    batch = _counted(lambda: model.inference_rgb_device(stack, hw), route, blocks, f"{what} batch of 8")
    _check_depth(batch, (8, *out_hw), f"{what} batch of 8")
    if not (torch.equal(batch[6], batch[0]) and torch.equal(batch[7], batch[3])):
        raise RuntimeError(f"{what} batch: duplicate frames gave different depth")
    print(f"{what} bf16: 3 requests -> {(1, *out_hw)}, batch -> {(8, *out_hw)}, {blocks} {route} launches per forward, "
          "duplicates bit-equal", flush=True)

    def per_request():
        model.inference(frames[0], side)
        torch.cuda.synchronize()

    def per_batch():
        model.inference_rgb_device(stack, hw)
        torch.cuda.synchronize()

    ms_b1, ms_b8 = _host_ms(per_request), _host_ms(per_batch) / 8
    print(f"{what} bf16 steady state: {ms_b1:.3f} ms per request at B=1, {ms_b8:.3f} ms per frame at B=8 [{smi}]", flush=True)
    return first, frames[0]


def phase_da_model(smi: str, ckpt: str):
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    fa.reset_launch_counts()  # count the path's run only
    depth, frame = serve(smi, model, MAX_SIDE, OUT_HW, "fused", VITL["num_blocks"], "DA-V2 ViT-L")
    return fa.flash_attention_fused_qkv.launches, depth, frame


def parity(ckpt, frame, side, out_hw, route, blocks, what, bf16_depth, cache_modes=(True,)):
    """f32 kernel model vs f32 plain model on the same checkpoint and frame."""
    _, m_kernel = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE, enable_optimizations=True)
    _, m_plain = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE, enable_optimizations=False)
    _, m_plain_bf16 = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE, enable_optimizations=False)
    for enable_cache in cache_modes:
        for m in (m_kernel, m_plain, m_plain_bf16):
            m.config["enable_cache"] = enable_cache
        d_kernel = _counted(lambda: m_kernel.inference(frame, side), route, blocks, f"{what} f32 kernel model")
        d_plain = _counted(lambda: m_plain.inference(frame, side), route, 0, f"{what} f32 plain model")
        _check_depth(d_kernel, (1, *out_hw), f"{what} f32 kernel model")
        _check_depth(d_plain, (1, *out_hw), f"{what} f32 plain model")
        rel, rel_bf16 = _abs_rel(d_kernel, d_plain), _abs_rel(bf16_depth, d_plain)
        rel_plain_bf16 = _abs_rel(m_plain_bf16.inference(frame, side), d_plain)
        mode = f" (enable_cache={enable_cache})" if len(cache_modes) > 1 else ""
        print(f"{what} f32 kernel vs plain{mode}: mean abs-rel {rel:.3e} (budget {ABS_REL_BUDGET:g}); "
              f"vs f32 plain, not gated: bf16 kernel model {rel_bf16:.3e}, bf16 plain model {rel_plain_bf16:.3e}", flush=True)
        if not rel <= ABS_REL_BUDGET:
            raise RuntimeError(f"{what}: f32 kernel model disagrees with the plain model: abs-rel {rel:.3e}")


def phase_beit_model(smi: str, ckpt: str):
    """BEiT-L-512 bf16: 512x512 serving, then one 1024x1024 request through
    the cached stack; then the 1024x1024 stack's last layer (an element
    offset past 2**31) against the plain version."""
    blocks = BEIT_L512["num_blocks"]
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    fa.reset_launch_counts()  # count the path's run only
    depth, frame = serve(smi, model, BEIT_SIDE, BEIT_HW, "fused_biased", blocks, "BEiT-L-512")
    rng = np.random.default_rng(SEED + 2)
    big = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    out = _counted(lambda: model.inference(big, BEIT_BIG_SIDE), "fused_biased", blocks, "BEiT-L-512 1024x1024")
    _check_depth(out, (1, BEIT_BIG_SIDE, BEIT_BIG_SIDE), "BEiT-L-512 1024x1024")
    grid = (BEIT_BIG_SIDE // model.patch_size_px,) * 2
    stack = model._aux_cache[grid]
    if stack is None:
        raise RuntimeError("BEiT-L-512 1024x1024: the bias stack was not cached")
    print(f"BEiT-L-512 bf16 1024x1024 request: {(time.perf_counter() - t0) * 1e3:.1f} ms, first at this size "
          f"(bias stack {tuple(stack.shape)} {str(stack.dtype)[6:]}, {stack.numel() * stack.element_size() / 1e9:.2f} GB, "
          f"built once and cached) [{smi}]", flush=True)
    launches = fa.flash_attention_fused_qkv.biased_launches
    n = grid[0] * grid[1] + 1
    qkv = make_qkv(rng, 1, n, torch.bfloat16)
    kw = {"bias_stack": stack, "layer": blocks - 1}
    offset = (blocks - 1) * stack.stride(0)
    check = Checker()
    check(2, f"bfloat16 B=1 N={n} model stack layer {blocks - 1} (offset {offset} elements)",
          fa.flash_attention_fused_qkv(qkv, HEADS, **kw), fa.flash_attention_fused_qkv_reference(qkv, HEADS, **kw),
          (1, n, HEADS * HEAD_DIM))
    return launches, depth, frame, check.worst[2]


def phase_swin_model(smi: str, ckpt: str):
    """SwinV2-L-384 bf16: 384x384 serving, then one 512x512 request, its
    CPB stacks and masks built on the way."""
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    fa.reset_launch_counts()  # count the path's run only
    depth, frame = serve(smi, model, SWIN_SIDE, SWIN_HW, "window", SWIN_BLOCKS, "SwinV2-L-384")
    big = np.random.default_rng(SEED + 2).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _counted(lambda: model.inference(big, SWIN_BIG_SIDE), "window", SWIN_BLOCKS, "SwinV2-L-384 512x512")
    ms = (time.perf_counter() - t0) * 1e3
    _check_depth(out, (1, SWIN_BIG_SIDE, SWIN_BIG_SIDE), "SwinV2-L-384 512x512")
    grid = (SWIN_BIG_SIDE // model.patch_size_px,) * 2
    aux = model._aux_cache.get(grid)
    if aux is None:
        raise RuntimeError("SwinV2-L-384 512x512: the CPB stacks were not cached")
    windows = [window_plan(g, SWIN_L384["window_size_hw"])[0] for g in stage_grids(grid)]
    gb = sum(t.numel() * t.element_size() for stage in aux for t in stage.values() if t is not None) / 1e9
    print(f"SwinV2-L-384 bf16 512x512 request: {ms:.1f} ms, first at this size (CPB stacks and masks, {gb:.3f} GB, "
          f"built once and cached); windows per stage {windows} [{smi}]", flush=True)
    return wa.window_attention.launches, depth, frame


def phase_bnhd_path(smi: str) -> tuple[int, int]:
    """The (B, N, H, D) op: BEiT-L-512's attention shape (B=8, q, k, v as
    strided views of one qkv, a padded (1, H, Np, Np) bias as the JAX BEiT
    route hands it over), then 32897 keys."""
    rng = np.random.default_rng(SEED + 3)
    qkv = make_qkv(rng, 8, N_BEIT, torch.bfloat16)
    bias = padded_stack(rng, 1, N_BEIT, torch.bfloat16)  # (1, H, Np, Np), pads 1e6
    fa.reset_launch_counts()  # count the path's run only
    out = _counted(lambda: fa.flash_attention(*_split(qkv), bias=bias), "bnhd", 1, "(B, N, H, D) op")
    _check_depth(out, (8, N_BEIT, HEADS, HEAD_DIM), "(B, N, H, D) op")
    at_beit = fa.flash_attention.launches
    q, k, v = (make_bias(rng, (1, N_ONLINE, 2, HEAD_DIM), torch.bfloat16) for _ in range(3))
    out = _counted(lambda: fa.flash_attention(q, k, v), "bnhd", 1, f"(B, N, H, D) op at {N_ONLINE} keys")
    _check_depth(out, (1, N_ONLINE, 2, HEAD_DIM), f"(B, N, H, D) op at {N_ONLINE} keys")
    online = fa.flash_attention.launches - at_beit
    print(f"(B, N, H, D) op: {at_beit} launch at B=8 N={N_BEIT} with bias, {online} at N={N_ONLINE}", flush=True)
    return at_beit, online


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def write_checkpoint(sd: dict, path: str) -> str:
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def main() -> int:
    smi = timed("device", phase_device)
    timed("build", phase_build)
    numbers = timed("kernel checks and times", phase_kernel, smi)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_checkpoint(random_original_depth_anything_state_dict(VITL, seed=SEED),
                                os.path.join(tmp, "depth_anything_v2_vitl_random.pth"))
        launches[1], depth, frame = timed("DA-V2 model", phase_da_model, smi, ckpt)
        timed("DA-V2 f32 parity", parity, ckpt, frame, MAX_SIDE, OUT_HW, "fused", VITL["num_blocks"], "DA-V2 ViT-L", depth)
        os.remove(ckpt)
        ckpt = write_checkpoint(random_beit_state_dict(BEIT_L512, seed=SEED), os.path.join(tmp, "dpt_beit_large_512_random.pt"))
        launches[2], depth, frame, err = timed("BEiT model", phase_beit_model, smi, ckpt)
        numbers[2]["max_abs_err"] = max(numbers[2]["max_abs_err"], err)
        timed("BEiT f32 parity", parity, ckpt, frame, BEIT_SIDE, BEIT_HW, "fused_biased", BEIT_L512["num_blocks"],
              "BEiT-L-512", depth, (True, False))
        os.remove(ckpt)
        ckpt = write_checkpoint(random_swinv2_state_dict(SWIN_L384, seed=SEED), os.path.join(tmp, "dpt_swin2_large_384_random.pt"))
        launches[3], depth, frame = timed("SwinV2 model", phase_swin_model, smi, ckpt)
        timed("SwinV2 f32 parity", parity, ckpt, frame, SWIN_SIDE, SWIN_HW, "window", SWIN_BLOCKS, "SwinV2-L-384", depth,
              (True, False))
    launches[4], launches[5] = timed("(B, N, H, D) op path", phase_bnhd_path, smi)
    kernels = [
        {
            "name": NAMES[kid],
            "route": "cuda",
            "source": f"muggled_dpt_tpu_torch/csrc/{'window_attention' if kid == 3 else 'flash_attention'}.cu",
            "replaces": REPLACES[kid],
            "launches": launches[kid],
            **numbers[kid],
        }
        for kid in (1, 2, 3, 4, 5)
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise RuntimeError(f"a kernel of the paths never launched: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
