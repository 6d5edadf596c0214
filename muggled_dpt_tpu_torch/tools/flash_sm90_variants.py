#!/usr/bin/env python3
"""Design variants of the unbiased bf16 attention kernel
(``csrc/flash_attention_sm90.cu``), timed on the card.

    python3 muggled_dpt_tpu_torch/tools/flash_sm90_variants.py

Each variant is the source as committed with one design decision undone by
a text edit, built by nvcc into a library of its own (under the gitignored
``build/variants/``) with a C entry over raw pointers, and timed with CUDA
events in two turns (forward, then backward, the faster median kept) on
random head-major qkv slabs from a seed at DA-V2 ViT-L's shapes, (8, 1297,
3072), (1, 5477, 3072) and (1, 18497, 3072), beside one SDPA call:
  * ``kernel``: as committed (three consumer warpgroups of 64 q rows, the
    consumers taking turns on the tensor cores, the scale folded into the
    exp2's FFMA);
  * ``2 consumers``: 128 q rows, 240 registers per consumer thread;
  * ``2 consumers, FMUL scale``: and the softmax's first form (the logits
    scaled by an FMUL, then the max, then exp2 of the difference): the
    kernel as first built;
  * ``no turns``: the named barriers that order the consumers removed;
  * ``3 stages``: a K/V ring of three stages;
  * ``no softmax`` and ``2 consumers, no softmax``: S scaled and packed to
    P with no max, exp2 or sum, a timing floor whose output is not
    attention.
Each output is compared with SDPA's (the floors excepted). Runs only on a
CUDA card; every line carries the card's name and power limit."""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

if __name__ == "__main__":  # run as a script: the package of this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from muggled_dpt_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc  # noqa: E402

SHAPES = ((8, 1297), (1, 5477), (1, 18497))  # (B, N) of DA-V2 ViT-L's qkv slab: 504x504 at B=8, 1036 and 1904 at B=1
HEADS, HEAD_DIM = 16, 64
ENTRY = r"""
extern "C" int run(const void* q, const void* k, const void* v, void* o, const long long* st_in, const long long* st_out,
                   int batch, int n, int heads, float scale_log2, void* stream) {
    return (int)flash_attention_sm90(q, st_in, k, st_in, v, st_in, o, st_out, batch, n, heads, scale_log2,
                                     (cudaStream_t)stream);
}
"""
SOFTMAX_START = "template <bool MASK>\n__device__ __forceinline__ void online_softmax("
SOFTMAX_END = "__device__ __forceinline__ void softmax_tile("
SOFTMAX_HEAD = """template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                               int kbase, int n, int c) {
"""
FMUL_SOFTMAX = SOFTMAX_HEAD + """    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float v = s[4 * i + e] * scale_log2;
            if (MASK && key_masked(kbase, i, e, c, n)) v = NEG_INF;
            s[4 * i + e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2(s[4 * i + e] - m[e >> 1]);
            s[4 * i + e] = p;
            l[e >> 1] += p;
        }
    }
}

"""
NO_SOFTMAX = SOFTMAX_HEAD + """    alpha[0] = alpha[1] = 1.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        s[i] *= scale_log2;
        l[i & 1] += s[i];
    }
}

"""
TWO_CONSUMERS = [("constexpr int CONSUMERS = 3;", "constexpr int CONSUMERS = 2;"),
                 ("CONSUMER_REGS = 160;", "CONSUMER_REGS = 240;")]
NO_TURNS = [('asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");', ""),
            ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', "")]
VARIANTS = {  # name: (text replacements, softmax body or None, a timing floor)
    "kernel": ([], None, False),
    "2 consumers": (TWO_CONSUMERS, None, False),
    "2 consumers, FMUL scale": (TWO_CONSUMERS, FMUL_SOFTMAX, False),
    "no turns": (NO_TURNS, None, False),
    "3 stages": ([("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")], None, False),
    "no softmax": ([], NO_SOFTMAX, True),
    "2 consumers, no softmax": (TWO_CONSUMERS, NO_SOFTMAX, True),
}


def variant_source(source: str, replacements, softmax) -> str:
    for old, new in replacements:
        if old not in source:
            raise RuntimeError(f"the source no longer holds {old!r}")
        source = source.replace(old, new)
    if softmax is not None:
        start, end = source.index(SOFTMAX_START), source.index(SOFTMAX_END)
        source = source[:start] + softmax + source[end:]
    return source + ENTRY


def build() -> dict:
    """Every variant compiled at once, one nvcc each; returns {name: library}."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (CSRC_DIR / "flash_attention_sm90.cu").read_text()
    jobs = {}
    for i, (name, (replacements, softmax, _)) in enumerate(VARIANTS.items()):
        src, lib = out_dir / f"variant{i}.cu", out_dir / f"variant{i}.so"
        src.write_text(variant_source(source, replacements, softmax))
        cmd = [find_nvcc(), "-Xptxas=-v", *NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        used = [line.split(":", 1)[-1].strip() for line in log.splitlines() if "Used" in line or "spill" in line]
        print(f"variant {name!r}: {'; '.join(used)}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].run.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        libs[name].run.restype = ctypes.c_int
    return libs


def time_ms(fn, iters: int, warmup: int) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_sm90_variants.py runs on a CUDA card")
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    smi = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = HEAD_DIM**-0.5
    for b, n in SHAPES:
        c3 = 3 * HEADS * HEAD_DIM
        qkv = torch.randn(b, n, c3, device="cuda", dtype=torch.bfloat16, generator=gen)
        out = torch.empty(b, n, HEADS * HEAD_DIM, device="cuda", dtype=torch.bfloat16)
        st_in = (ctypes.c_longlong * 3)(n * c3, c3, 3 * HEAD_DIM)
        st_out = (ctypes.c_longlong * 3)(n * HEADS * HEAD_DIM, HEADS * HEAD_DIM, HEAD_DIM)
        q, k, v = (t.transpose(1, 2) for t in qkv.unflatten(2, (HEADS, 3, HEAD_DIM)).unbind(3))
        ref = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, HEADS * HEAD_DIM).float()
        stream = torch.cuda.current_stream().cuda_stream
        ptr, es = qkv.data_ptr(), qkv.element_size()
        calls = {name: (lambda lib=lib: lib.run(ptr, ptr + HEAD_DIM * es, ptr + 2 * HEAD_DIM * es, out.data_ptr(), st_in,
                                                 st_out, b, n, HEADS, scale * 1.4426950408889634, stream))
                 for name, lib in libs.items()}
        for name, call in calls.items():
            err = call()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"variant {name!r} failed to launch: CUDA error {err}")
            if not VARIANTS[name][2]:
                diff = float((out.float() - ref).abs().max())
                print(f"  {name} B={b} N={n}: max abs difference from SDPA {diff:.3e}", flush=True)
                if not diff <= 2e-2:
                    raise RuntimeError(f"variant {name!r} disagrees with SDPA at B={b} N={n}")
        iters, warmup = (30, 5) if n <= 10405 else (10, 2)
        readings = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                readings[name].append(time_ms(calls[name], iters, warmup))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters, warmup)
        flops = 4 * b * HEADS * n * n * HEAD_DIM
        print(f"B={b} N={n} H={HEADS} D={HEAD_DIM} bf16 (median of {iters} after {warmup}, two turns) [{smi}]", flush=True)
        for name, ms in ((name, min(r)) for name, r in readings.items()):
            print(f"  {name:26s} {ms:8.4f} ms  {flops / ms / 1e9:5.0f} TFLOP/s  {ms / min(readings['kernel']):5.2f}x kernel",
                  flush=True)
        print(f"  {'SDPA':26s} {sdpa:8.4f} ms  {flops / sdpa / 1e9:5.0f} TFLOP/s  {sdpa / min(readings['kernel']):5.2f}x kernel",
              flush=True)
        del qkv, out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
