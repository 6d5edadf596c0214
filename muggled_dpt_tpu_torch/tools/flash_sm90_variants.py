#!/usr/bin/env python3
"""Design variants of the bf16 attention kernel (``csrc/flash_attention_sm90.cu``),
unbiased and biased, timed on the card.

    python3 muggled_dpt_tpu_torch/tools/flash_sm90_variants.py

Each variant is the source as committed with one design decision undone by
a text edit, built into a library of its own by ``variant_build.py`` (under
the gitignored ``build/variants/``, with ``csrc/`` on the include path for
its header ``sm90_attention.cuh``) with a C entry over raw pointers, and
timed with CUDA events in two turns (forward, then backward, the faster
median kept) beside one SDPA call, on random inputs from a seed:
  * unbiased (#1): head-major qkv slabs at DA-V2 ViT-L's (8, 1297, 3072) and
    (1, 18497, 3072);
  * biased (#2): BEiT-L-512's (8, 1025, 3072) slab with layer 23 of a
    (24, 16, 1032, 1032) padded stack (1e6 in the pads), its tiles filled by
    TMA and, the same inputs, by the producer warps' copy; and the
    1024x1024 request's (1, 4097, 3072) slab with layer 23 of the
    (24, 16, 4104, 4104) stack (12.9 GB). SDPA takes the layer as attn_mask.
Variants:
  * ``kernel``: as committed (three consumer warpgroups of 64 q rows issuing
    freely, the grid batch fastest);
  * ``batch slowest``: the grid (q tile, head, batch), the order before the
    bias operand;
  * ``2 consumers``: 128 q rows, 240 registers per consumer thread (24 for the producer).
Each output is compared with SDPA's. Runs only on a CUDA card; every line
carries the card's name and power limit."""

from __future__ import annotations

import ctypes
import os
import sys

import torch
import torch.nn.functional as F

if __name__ == "__main__":  # run as a script: the package of this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from muggled_dpt_tpu_torch.ops.kernels._build import CSRC_DIR  # noqa: E402
from muggled_dpt_tpu_torch.tools import flash_tune as ft  # noqa: E402
from muggled_dpt_tpu_torch.tools import variant_build as vb  # noqa: E402

HEADS, HEAD_DIM = 16, 64
CASES = (  # (label, B, N, bias stack padded rows or None, fill: 0 TMA, 1 copy)
    ("#1 unbiased", 8, 1297, None, 0),
    ("#1 unbiased", 1, 18497, None, 0),
    ("#2 stack layer 23, TMA fill", 8, 1025, 1032, 0),
    ("#2 stack layer 23, copy fill", 8, 1025, 1032, 1),
    ("#2 1024x1024 stack layer 23, TMA fill", 1, 4097, 4104, 0),
)
LAYERS, LAYER = 24, 23
RUN_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
ENTRY = r"""
extern "C" int run(const void* q, const void* k, const void* v, void* o, const long long* st_in, const long long* st_out,
                   const void* bias, const long long* bias_st, int fill, int batch, int n, int heads, float scale_log2,
                   void* stream) {
    return (int)flash_attention_sm90(false, q, st_in, k, st_in, v, st_in, o, st_out, bias, bias_st, fill, batch, n, heads,
                                     scale_log2, (cudaStream_t)stream);
}
"""
TWO_CONSUMERS = [("constexpr int CONSUMERS = 3;", "constexpr int CONSUMERS = 2;"),  # 384 threads: 168 registers at launch
                 ("PRODUCER_REGS = 32, CONSUMER_REGS = 160;", "PRODUCER_REGS = 24, CONSUMER_REGS = 240;")]
BATCH_SLOWEST = [("const int b = blockIdx.x, q0 = blockIdx.y * BQ, h = blockIdx.z;",
                  "const int b = blockIdx.z, q0 = blockIdx.x * BQ, h = blockIdx.y;"),
                 ("const dim3 grid(batch, (p.n + BQ - 1) / BQ, heads);", "const dim3 grid((p.n + BQ - 1) / BQ, heads, batch);")]
VARIANTS = {  # name: text replacements
    "kernel": [],
    "batch slowest": BATCH_SLOWEST,
    "2 consumers": TWO_CONSUMERS,
}


def variant_source(source: str, replacements) -> str:
    return vb.edited(source, replacements, "csrc/flash_attention_sm90.cu") + ENTRY


def build() -> dict:
    """Every variant compiled at once, one nvcc each; returns {name: library}."""
    source = (CSRC_DIR / "flash_attention_sm90.cu").read_text()
    sources = {name: variant_source(source, replacements) for name, replacements in VARIANTS.items()}
    return vb.build(sources, "variants", dict.fromkeys(sources, RUN_ARGS))


def padded_stack(gen, n_pad: int, n: int) -> torch.Tensor:
    """A (24, H, Np, Np) bf16 bias stack with 1e6 in every pad."""
    stack = torch.randn(LAYERS, HEADS, n_pad, n_pad, device="cuda", dtype=torch.bfloat16, generator=gen)
    stack[..., n:, :] = 1e6
    stack[..., :, n:] = 1e6
    return stack


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_sm90_variants.py runs on a CUDA card")
    smi = vb.card()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = HEAD_DIM**-0.5
    stacks = {}
    for label, b, n, n_pad, fill in CASES:
        c3 = 3 * HEADS * HEAD_DIM
        qkv = torch.randn(b, n, c3, device="cuda", dtype=torch.bfloat16, generator=gen)
        out = torch.empty(b, n, HEADS * HEAD_DIM, device="cuda", dtype=torch.bfloat16)
        st_in = (ctypes.c_longlong * 3)(n * c3, c3, 3 * HEAD_DIM)
        st_out = (ctypes.c_longlong * 3)(n * HEADS * HEAD_DIM, HEADS * HEAD_DIM, HEAD_DIM)
        q, k, v = (t.transpose(1, 2) for t in qkv.unflatten(2, (HEADS, 3, HEAD_DIM)).unbind(3))
        bias, bias_st, mask = None, (ctypes.c_longlong * 4)(0, 0, 0, 0), None
        if n_pad is not None:
            if n_pad not in stacks:
                stacks = {n_pad: padded_stack(gen, n_pad, n)}  # one stack at a time: the 1024x1024 one is 12.9 GB
            layer = stacks[n_pad][LAYER]
            bias, mask = layer.data_ptr(), layer[None, :, :n, :n]
            bias_st = (ctypes.c_longlong * 4)(0, n_pad * n_pad, n_pad, 1)
        ref = F.scaled_dot_product_attention(q, k, v, attn_mask=mask).transpose(1, 2).reshape(b, n, HEADS * HEAD_DIM).float()
        stream = torch.cuda.current_stream().cuda_stream
        ptr, es = qkv.data_ptr(), qkv.element_size()
        calls = {name: (lambda lib=lib: lib.run(ptr, ptr + HEAD_DIM * es, ptr + 2 * HEAD_DIM * es, out.data_ptr(), st_in,
                                                 st_out, bias, bias_st, fill, b, n, HEADS, scale * 1.4426950408889634, stream))
                 for name, lib in libs.items()}
        for name, call in calls.items():
            err = call()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"variant {name!r} failed to launch: CUDA error {err}")
            diff = float((out.float() - ref).abs().max())
            print(f"  {name} {label} B={b} N={n}: max abs difference from SDPA {diff:.3e}", flush=True)
            if not diff <= 2e-2:
                raise RuntimeError(f"variant {name!r} disagrees with SDPA at {label} B={b} N={n}")
        iters, warmup = (30, 5) if n <= 10405 else (10, 2)
        readings = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                readings[name].append(ft.time_ms(calls[name], iters, warmup))
        sdpa = ft.time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters, warmup)
        flops = 4 * b * HEADS * n * n * HEAD_DIM
        print(f"{label} B={b} N={n} H={HEADS} D={HEAD_DIM} bf16 (median of {iters} after {warmup}, two turns) [{smi}]",
              flush=True)
        for name, ms in ((name, min(r)) for name, r in readings.items()):
            print(f"  {name:26s} {ms:8.4f} ms  {flops / ms / 1e9:5.0f} TFLOP/s  {ms / min(readings['kernel']):5.2f}x kernel",
                  flush=True)
        print(f"  {'SDPA':26s} {sdpa:8.4f} ms  {flops / sdpa / 1e9:5.0f} TFLOP/s  {sdpa / min(readings['kernel']):5.2f}x kernel",
              flush=True)
        del qkv, out, ref, q, k, v, mask
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
