#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, through its
hand-written kernel, and check what comes out.

    python3 chip_smoke.py

Model: Depth-Anything V2 ViT-L at full width (F=1024, 24 blocks, 16 heads x
64), random weights from a seed, written as an original-format checkpoint
and loaded through ``make_dpt_from_state_dict``. Requests: a 720x1280 BGR
frame at max side 518, which snaps to 504x504 (1297 tokens).

Phases, in order; each prints one line and any failure raises:
  1. device: a CUDA card, or fail; the nvidia-smi name and power limit;
  2. build: nvcc builds the kernel library from csrc/;
  3. kernel vs its plain version at the main-path shapes and edge cases,
     float32 and bfloat16, with CUDA-event times of both;
  4. the bf16 model serves 3 requests through ``inference`` and one batch of
     8 frames through ``inference_rgb_device``; every forward launches the
     attention kernel 24 times;
  5. float32 model with the kernel vs float32 model on the plain path.
Then one JSON line of per-kernel results, and last the ok line.

Imports only torch, numpy and the port: never jax or the JAX package."""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.make_dpt import make_dpt_from_state_dict
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa

VITL = {
    "features_per_token": 1024,
    "num_blocks": 24,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 14,
    "base_patch_grid_hw": (37, 37),
}
HEADS, HEAD_DIM = 16, 64
FRAME_HW, MAX_SIDE, OUT_HW = (720, 1280), 518, (504, 504)
N_TOKENS = 1 + (OUT_HW[0] // 14) * (OUT_HW[1] // 14)  # 1297
SEED = 0

# tolerances of the kernel against its plain version on the same inputs
F32_MAX_ERR = 1e-4  # f32 FMAs in another summation order
BF16_MAX_ERR, BF16_MEAN_ERR = 2e-2, 2e-3  # p rounded to bf16 before PV, bf16 output
ABS_REL_BUDGET = 1e-3  # whole-model f32 budget of the repo


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

    t0 = time.perf_counter()
    path = build_library(verbose=True)
    kernel_library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)


def make_qkv(rng, b, n, dtype, all_negative=False):
    """Head-major (B, N, 3C) qkv on the card, drawn with numpy. all_negative
    makes every logit strongly negative: q = -8|x|, k = |y|."""
    x = rng.standard_normal((b, n, HEADS, 3, HEAD_DIM), dtype=np.float32)
    if all_negative:
        x[..., 0, :] = -8.0 * np.abs(x[..., 0, :])
        x[..., 1, :] = np.abs(x[..., 1, :])
    return torch.from_numpy(x.reshape(b, n, 3 * HEADS * HEAD_DIM)).to("cuda", dtype)


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


def phase_kernel(smi: str) -> dict:
    """Kernel vs plain version; returns the bf16 main-path numbers for the JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true f32
    rng = np.random.default_rng(SEED)
    # (B, N, all-negative logits, scale): the main-path shapes, then edge cases
    cases = [(1, N_TOKENS, False, None), (8, N_TOKENS, False, None), (1, 1, False, None), (1, 63, False, None),
             (1, 65, False, None), (2, 200, False, None), (2, 200, False, 0.3), (2, 200, True, None),
             (1, N_TOKENS, True, None)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, neg, scale in cases:
            qkv = make_qkv(rng, b, n, dtype, neg)
            got = fa.flash_attention_fused_qkv(qkv, HEADS, scale).float()
            ref = fa.flash_attention_fused_qkv_reference(qkv, HEADS, scale).float()
            torch.cuda.synchronize()
            err = (got - ref).abs()
            max_err, mean_err = float(err.max()), float(err.mean())
            label = f"{str(dtype)[6:]} B={b} N={n}{' all-negative' if neg else ''}{f' scale={scale}' if scale else ''}"
            ok = bool(torch.isfinite(got).all()) and got.shape == (b, n, HEADS * HEAD_DIM)
            if dtype == torch.float32:
                ok = ok and max_err <= F32_MAX_ERR
            else:
                ok = ok and max_err <= BF16_MAX_ERR and mean_err <= BF16_MEAN_ERR
            print(f"kernel check {label}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e}", flush=True)
            if not ok:
                raise RuntimeError(f"kernel disagrees with its plain version at {label}")
            if n == N_TOKENS and not neg and scale is None:
                worst[(dtype, b)] = max_err

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 8):
            qkv = make_qkv(rng, b, N_TOKENS, dtype)
            kernel = lambda: fa.flash_attention_fused_qkv(qkv, HEADS)  # noqa: E731
            plain = lambda: fa.flash_attention_fused_qkv_reference(qkv, HEADS)  # noqa: E731
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
            times[(dtype, b)] = (min(k1, k2), min(p1, p2))
            print(
                f"kernel time {str(dtype)[6:]} B={b} N={N_TOKENS} H={HEADS} D={HEAD_DIM}: "
                f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms [{smi}]",
                flush=True,
            )
    ms, plain_ms = times[(torch.bfloat16, 8)]
    return {
        "max_abs_err": max(worst[(torch.bfloat16, 1)], worst[(torch.bfloat16, 8)]),
        "ms": ms,
        "plain_ms": plain_ms,
    }


def _abs_rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    return float((ours.float() - ref.float()).abs().mean() / (ref.float().abs().mean() + 1e-12))


def _check_depth(depth, shape, what):
    if tuple(depth.shape) != shape or not bool(torch.isfinite(depth).all()):
        raise RuntimeError(f"{what}: got shape {tuple(depth.shape)} (want {shape}), finite={bool(torch.isfinite(depth).all())}")


def phase_model(smi: str, ckpt: str) -> tuple[int, torch.Tensor, np.ndarray]:
    """bf16 serving through the public entry points. Returns the kernel's
    launch count over the main-path run, the first request's depth and its frame."""
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(6)]
    blocks = VITL["num_blocks"]

    fa.flash_attention_fused_qkv.launches = 0  # count the main path's run only
    first = None
    for i in range(3):
        before = fa.flash_attention_fused_qkv.launches
        depth = model.inference(frames[i], MAX_SIDE)
        torch.cuda.synchronize()
        _check_depth(depth, (1, *OUT_HW), f"request {i}")
        if fa.flash_attention_fused_qkv.launches - before != blocks:
            raise RuntimeError(f"request {i}: {fa.flash_attention_fused_qkv.launches - before} kernel launches, want {blocks}")
        first = depth if first is None else first
    hw = model.compute_scaled_hw(FRAME_HW, MAX_SIDE)
    batch_frames = frames + [frames[0], frames[3]]  # rows 6 and 7 duplicate rows 0 and 3
    stack = torch.from_numpy(np.stack(batch_frames)).to("cuda")
    before = fa.flash_attention_fused_qkv.launches
    batch = model.inference_rgb_device(stack, hw)
    torch.cuda.synchronize()
    launches = fa.flash_attention_fused_qkv.launches
    _check_depth(batch, (8, *OUT_HW), "batch of 8")
    if launches - before != blocks:
        raise RuntimeError(f"batch: {launches - before} kernel launches, want {blocks}")
    if not (torch.equal(batch[6], batch[0]) and torch.equal(batch[7], batch[3])):
        raise RuntimeError("batch: duplicate frames gave different depth")
    print(
        f"model bf16: 3 requests -> {(1, *OUT_HW)}, batch -> {(8, *OUT_HW)}, {launches} kernel launches "
        f"({blocks} per forward), duplicates bit-equal",
        flush=True,
    )

    def per_request():
        model.inference(frames[0], MAX_SIDE)
        torch.cuda.synchronize()

    def per_batch():
        model.inference_rgb_device(stack, hw)
        torch.cuda.synchronize()

    ms_b1 = _host_ms(per_request)
    ms_b8 = _host_ms(per_batch) / 8
    print(f"model bf16 steady state: {ms_b1:.3f} ms per request at B=1, {ms_b8:.3f} ms per frame at B=8 [{smi}]", flush=True)
    return launches, first, frames[0]


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


def phase_parity(ckpt: str, bf16_depth: torch.Tensor, frame: np.ndarray):
    """f32 kernel model vs f32 plain model on the same checkpoint and frame."""
    _, m_kernel = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device="cuda", enable_optimizations=True)
    _, m_plain = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device="cuda", enable_optimizations=False)
    before = fa.flash_attention_fused_qkv.launches
    d_kernel = m_kernel.inference(frame, MAX_SIDE)
    d_plain = m_plain.inference(frame, MAX_SIDE)
    torch.cuda.synchronize()
    if fa.flash_attention_fused_qkv.launches - before != VITL["num_blocks"]:
        raise RuntimeError("f32 parity: the kernel model did not run the kernel once per block")
    _check_depth(d_kernel, (1, *OUT_HW), "f32 kernel model")
    _check_depth(d_plain, (1, *OUT_HW), "f32 plain model")
    rel = _abs_rel(d_kernel, d_plain)
    rel_bf16 = _abs_rel(bf16_depth, d_plain)
    print(
        f"model f32 kernel vs plain: mean abs-rel {rel:.3e} (budget {ABS_REL_BUDGET:g}); "
        f"bf16 kernel model vs f32 plain: {rel_bf16:.3e} (not gated)",
        flush=True,
    )
    if not rel <= ABS_REL_BUDGET:
        raise RuntimeError(f"f32 kernel model disagrees with the plain model: abs-rel {rel:.3e}")


def main() -> int:
    smi = phase_device()
    phase_build()
    kernel_numbers = phase_kernel(smi)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "depth_anything_v2_vitl_random.pth")
        sd = random_original_depth_anything_state_dict(VITL, seed=SEED)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
        del sd
        launches, bf16_depth, frame = phase_model(smi, ckpt)
        phase_parity(ckpt, bf16_depth, frame)
    kernels = [
        {
            "name": "flash_attention_fused_qkv",
            "route": "cuda",
            "source": "muggled_dpt_tpu_torch/csrc/flash_attention_fused_qkv.cu",
            "replaces": "muggled_dpt_tpu/ops/pallas/flash_attention.py:125",
            "launches": launches,
            **kernel_numbers,
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
