#!/usr/bin/env python3
"""Design variants of the int8-QK^T attention's Hopper kernels, #6 and #7
(``csrc/flash_attention_int8_sm90.cu``: the quantize prologue and the int8
wgmma/TMA attention kernel), timed on the card.

    python3 muggled_dpt_tpu_torch/tools/int8_sm90_variants.py [--out DIR] [NAME ...]

Each variant is the source as committed with its constants (``CONSUMERS``,
``STAGES``, ``PRO_ROWS``) set, or a piece of its
code changed, by a text edit, built by ``variant_build.py`` (nvcc with
``-Xptxas=-v``) into a library of its own (under the gitignored
``build/int8_sm90_variants/``, with ``csrc/`` on the include path) with a C
entry over raw pointers, all builds started together. For each variant it
prints the build's seconds and, per kernel, ptxas's registers and spills and
any wgmma serialization warning (C75xx); ``--out DIR`` writes each build's
whole output to ``DIR/int8_sm90_variant_<n>.txt`` and every line printed
after the builds to ``DIR/int8_sm90_variants.txt``. Each variant's prologue
is held to the plain prologue (``quantize_fused``, ``quantize_rows``) by
``torch.equal`` and its output to the plain version within chip_smoke.py's
bf16 gates (max 2e-2, mean 2e-3) at every case of ``CASES``, then timed at
the timed ones as device time (``flash_tune.device_ms``: 20 calls queued
behind a spin of the card, mean after 3 warm-ups, two turns, the faster
kept): the whole call (prologue and attention), the prologue alone and the
attention alone; beside them one SDPA call on the slab's q, k and v views
and kernel #1 on the slab, timed the same way. Inputs: N(0, 1) from the
seed, bf16.
Variants:
  * ``committed``: the source as it is (192 q rows per CTA, a K/V ring of
    2 stages, s = float(i) * alpha with the integer made a float by I2F,
    then exp2(s - m); P packed and its rounded values summed after the PV
    wait; the prologue in two launches over chunks of 64 rows);
  * ``bias trick``: the integer logits made floats on the FP32 pipe (1.5 *
    2^23 added to the bits, then subtracted as a float), not by I2F on the
    SFU's pipe beside the exp2;
  * ``4 stages``: a K/V ring of 4 (an int8 K tile is half a bf16 one);
  * ``pack in softmax``, ``pack in softmax, bias trick``: P packed and
    summed in the softmax, under the PV, then copied to the PV's registers;
  * ``fold``: the logit scale folded into the exp2's FFMA, p =
    exp2(float(i) * alpha - m), the row max taken on the integers (one
    rounding less than the plain version's s = float(i) * alpha, then s - m);
  * ``128 rows``: two consumer warpgroups (232 registers each), 128 q rows
    per CTA;
  * ``prologue one launch``: one CTA per (head, batch) runs both passes;
    ``prologue 32 rows``, ``prologue 128 rows``: the two launches over
    chunks of 32 or 128 rows;
  * ablations, timed but not held against the plain version (their output
    is not the function's): ``no exp`` (p = s - m, no exp2), ``no row sum``
    (l not summed), ``no pv`` (no PV product; the V tiles still load),
    ``mainloop only`` (no softmax: the loads and both products, the raw
    integers taken as P).
Runs only on a CUDA card; every table carries the card's name and power
limit."""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys

import numpy as np
import torch
import torch.nn.functional as F

if __name__ == "__main__":  # run as a script: the package of this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_int8 as fi8  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels._build import CSRC_DIR  # noqa: E402
from muggled_dpt_tpu_torch.tools import flash_tune as ft  # noqa: E402
from muggled_dpt_tpu_torch.tools import variant_build as vb  # noqa: E402

SOURCE = "flash_attention_int8_sm90.cu"
ENTRY = r"""
extern "C" int run(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                   const long long* v_st, void* o, const long long* o_st, void* q_i8, void* k_i8, float* alpha, float* kmax,
                   int bf16, int batch, int n, int heads, int mode, float q_mul, float scale, int stages, void* stream) {
    cudaError_t err = cudaSuccess;
    if (stages & 1)
        err = int8_prologue(q, q_st, k, k_st, bf16, q_i8, k_i8, alpha, kmax, batch, n, heads, mode, q_mul, scale,
                            (cudaStream_t)stream);
    if (err == cudaSuccess && (stages & 2))
        err = flash_attention_int8_sm90(q_i8, k_i8, alpha, v, v_st, o, o_st, batch, n, heads, (cudaStream_t)stream);
    return (int)err;
}
"""
ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
HEADS, D, N_TOKENS = 16, 64, 1297  # DA-V2 ViT-L at 504x504
CASES = (  # (label, entry, batch (#6: B H), N, timed)
    ("#7 B=8", 7, 8, N_TOKENS, True),
    ("#7 B=1", 7, 1, N_TOKENS, True),
    ("#6 BH=128", 6, 8 * HEADS, N_TOKENS, True),
    ("#7 B=2 N=200", 7, 2, 200, False),
    ("#7 B=1 N=129", 7, 1, 129, False),
)
BF16_MAX_ERR, BF16_MEAN_ERR = 2e-2, 2e-3  # chip_smoke.py's bf16 gates

EXP = "    for (int i = 0; i < 64; ++i) s[i] = __float_as_uint(ex2(__uint_as_float(s[i]) - m[(i >> 1) & 1]));\n"
TAKE_P = """__device__ __forceinline__ void take_p(uint32_t (&p)[8][4], const uint32_t (&s)[64], float (&l)[2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t pk = pack_bf16(__uint_as_float(s[8 * j + 2 * i]), __uint_as_float(s[8 * j + 2 * i + 1]));
            l[i & 1] += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xffff0000u);
            p[j][i] = pk;
        }
}
"""
ROW_SUM = "            l[i & 1] += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xffff0000u);\n"
PACK_IN_SOFTMAX = [  # P packed and its rounded values summed in the softmax, under the PV; then copied
    (EXP, """#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int a = 8 * j + 2 * i, r = i & 1;
            const uint32_t pk = pack_bf16(ex2(__uint_as_float(s[a]) - m[r]), ex2(__uint_as_float(s[a + 1]) - m[r]));
            l[r] += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xffff0000u);
            s[a] = pk;
        }
    }
"""),
    (TAKE_P, """__device__ __forceinline__ void take_p(uint32_t (&p)[8][4], const uint32_t (&s)[64], float (&l)[2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[j][i] = s[8 * j + 2 * i];
}
"""),
]
CONVERT = "            const float f = __int2float_rn(static_cast<int>(s[4 * i + e]));  // exact: |s| < 2^24\n"
BIAS_TRICK = (CONVERT, "            const float f = __uint_as_float(s[4 * i + e] + 0x4B400000u) - 12582912.0f;  // 1.5 * 2^23\n")
SCALE_AND_MASK = "            const float x = MASK && key_masked(kbase, i, e, c, n) ? NEG_INF : f * al[e >> 1];\n"
FIRST_LOOP = """    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
""" + CONVERT + SCALE_AND_MASK + """            s[4 * i + e] = __float_as_uint(x);
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
"""
FOLD = [  # the row max from the integers, s kept as float(int32), p = exp2(fma(s, alpha, -m))
    (FIRST_LOOP, """    // the row max of the integers (their min for a negative alpha): float(i) * alpha is monotone in i
    int top[2] = {-0x7fffffff - 1, -0x7fffffff - 1};
    const int sign = al[0] < 0.f ? -1 : 1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int v = static_cast<int>(s[4 * i + e]) * sign;
            if (!(MASK && key_masked(kbase, i, e, c, n))) top[e >> 1] = max(top[e >> 1], v);
            s[4 * i + e] = __float_as_uint(__int2float_rn(v * sign));  // float(int32), exact
        }
    }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = static_cast<float>(top[r] * sign) * al[r];
"""),
    (EXP, """#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[4 * i + e] = __float_as_uint(MASK && key_masked(kbase, i, e, c, n) ? 0.f
                                                   : ex2(fmaf(__uint_as_float(s[4 * i + e]), al[e >> 1], -m[e >> 1])));
"""),
]
ONE_LAUNCH = [  # both prologue passes in one launch: one CTA per (head, batch) over every chunk
    ("""template <typename T>
cudaError_t launch_prologue(const Prologue& p, int batch, cudaStream_t stream) {
    const dim3 grid(p.chunks, p.heads, batch);
    i8_pass_a<T><<<grid, PRO_THREADS, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    i8_pass_b<T><<<grid, PRO_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}""", """template <typename T>
__global__ void __launch_bounds__(PRO_THREADS) i8_onepass(const Prologue p) {
    const int h = blockIdx.y, b = blockIdx.z;
    float kmx = 0.f;
    for (int c = 0; c < p.chunks; ++c) kmx = fmaxf(kmx, quantize_q_chunk<T>(p, c, h, b));
    const float sk = __fdiv_rn(fmaxf(cta_max(kmx), 1e-12f), 127.0f);
    for (int c = 0; c < p.chunks; ++c) quantize_k_chunk<T>(p, c, h, b, sk);
}

template <typename T>
cudaError_t launch_prologue(const Prologue& p, int batch, cudaStream_t stream) {
    i8_onepass<T><<<dim3(1, p.heads, batch), PRO_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}"""),
]
SOFTMAX_CALL = "    softmax_tile(s, m, l, corr, al, 0, n, c);\n"
SOFTMAX_LOOP_CALL = "        softmax_tile(s, m, l, corr, al, t * BKV, n, c);\n"
VARIANTS = {  # name: ({constant: value}, text edits)
    "committed": ({}, []),
    "bias trick": ({}, [BIAS_TRICK]),
    "4 stages": ({"STAGES": 4}, []),
    "pack in softmax": ({}, PACK_IN_SOFTMAX),
    "pack in softmax, bias trick": ({}, PACK_IN_SOFTMAX + [BIAS_TRICK]),
    "fold": ({}, FOLD),
    "128 rows": ({"CONSUMERS": 2}, []),
    "prologue one launch": ({}, ONE_LAUNCH),
    "prologue 32 rows": ({"PRO_ROWS": 32}, []),
    "prologue 128 rows": ({"PRO_ROWS": 128}, []),
    "no exp": ({}, [(EXP, "    for (int i = 0; i < 64; ++i) s[i] = __float_as_uint(__uint_as_float(s[i]) - m[(i >> 1) & 1]);\n")]),
    "no row sum": ({}, [(ROW_SUM, "")]),
    "no pv": ({}, [("issue_pv(o, p, sm.v[pst]);", "")]),
    "mainloop only": ({}, [(SOFTMAX_CALL, ""), (SOFTMAX_LOOP_CALL, ""),
                           ("    float o[32], corr[2];\n", "    float o[32], corr[2] = {1.f, 1.f};\n")]),
}
UNCHECKED = ("no exp", "no row sum", "no pv", "mainloop only")  # ablations: timed, not held against the plain version
LOG = []  # the lines printed after the builds, for --out


def say(line: str):
    print(line, flush=True)
    LOG.append(line)


def with_constants(text: str, values: dict) -> str:
    """``text`` with each ``constexpr int|bool NAME = ...;`` line set to its value."""
    edits = []
    for name, value in values.items():
        m = re.search(rf"constexpr (?:int|bool) {name} = [^;]*;", text)
        if m is None:
            raise RuntimeError(f"csrc/{SOURCE} no longer declares {name}")
        edits.append((m.group(0), f"{m.group(0).split('=')[0]}= {str(value).lower()};"))
    return vb.edited(text, edits, f"csrc/{SOURCE}")


def variant_source(values: dict, edits=()) -> str:
    """The source with the constants set, the edits applied and the raw C entry appended."""
    return vb.edited(with_constants((CSRC_DIR / SOURCE).read_text(), values), edits, f"csrc/{SOURCE}") + ENTRY


def kernel_label(mangled: str) -> str:
    """fa_i8_sm90, i8_pass_a<bf16|f32>, i8_pass_b<..> or i8_onepass<..> from a mangled kernel name."""
    m = re.search(r"(i8_pass_a|i8_pass_b|i8_onepass)I(\w)", mangled)
    if m:
        return f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}>"
    return "fa_i8_sm90" if "fa_i8_sm90" in mangled else mangled[:60]


def build(names, out_dir) -> dict:
    """Every variant compiled at once, one nvcc each; returns {name: library}."""
    sources = {name: variant_source(*VARIANTS[name]) for name in names}
    return vb.build(sources, "int8_sm90_variants", {name: ARGS for name in names}, out_dir, "int8_sm90_variant", kernel_label)


def strides(values) -> ctypes.Array:
    return (ctypes.c_longlong * 3)(*values)


class Case:
    """One case's inputs on the card (#7: a (B, N, 3C) slab; #6: (B H, N, D)
    q, k, v), its scratch, sized for prologue chunks of 32 rows and up, and
    the plain prologue and output."""

    def __init__(self, gen, entry, b, n):
        self.entry, self.b, self.n = entry, b, n
        scale = D**-0.5
        if entry == 7:
            self.qkv = torch.randn(b, n, 3 * HEADS * D, device="cuda", generator=gen).bfloat16()
            h, (q, k, v) = HEADS, fa._qkv_operands(self.qkv, D)
            self.mode, self.q_mul = fi8.MODE_SQSK, scale * fi8.LOG2E
            q_i8, k_i8, alpha, _ = fi8.quantize_fused(self.qkv, HEADS, scale)
            self.want = fi8.flash_attention_int8_qk_fused_reference(self.qkv, HEADS).reshape(b, n, HEADS, D)
        else:
            self.qkv = [torch.randn(b, n, D, device="cuda", generator=gen).bfloat16() for _ in range(3)]
            h, (q, k, v) = 1, [fa._operand(name, t[:, :, None], t.device, t.dtype) for name, t in zip("qkv", self.qkv)]
            self.mode, self.q_mul = fi8.MODE_SCALED, 1.0
            q_i8, k_i8, alpha = (t[:, :, None] for t in fi8.quantize_rows(*self.qkv[:2], scale))
            self.want = fi8.flash_attention_int8_qk_reference(*self.qkv)[:, :, None]
        self.h, self.scale = h, scale
        self.plain_prologue = (q_i8, k_i8, alpha)
        self.q, self.k, self.v = ((spec[0], strides(spec[1:])) for spec in (q, k, v))
        self.out = torch.empty(b, n, h, D, dtype=torch.bfloat16, device="cuda")
        self.o_st = strides(self.out.stride()[:3])
        self.q_i8, self.k_i8 = (torch.empty(b, n, h, D, dtype=torch.int8, device="cuda") for _ in range(2))
        self.alpha = torch.empty(b, h, n, dtype=torch.float32, device="cuda")
        self.kmax = torch.empty(b, h, -(-n // 32), dtype=torch.float32, device="cuda")

    def call(self, lib, stages, stream):
        err = lib.run(self.q[0], self.q[1], self.k[0], self.k[1], self.v[0], self.v[1], self.out.data_ptr(), self.o_st,
                      self.q_i8.data_ptr(), self.k_i8.data_ptr(), self.alpha.data_ptr(), self.kmax.data_ptr(), 1, self.b,
                      self.n, self.h, self.mode, self.q_mul, self.scale, stages, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def check(self, name, label):
        torch.cuda.synchronize()
        q_i8, k_i8, alpha = self.plain_prologue
        same = (torch.equal(self.q_i8, q_i8), torch.equal(self.k_i8, k_i8), torch.equal(self.alpha.permute(0, 2, 1), alpha))
        err = (self.out.float() - self.want.float()).abs()
        ok = all(same) and bool(torch.isfinite(self.out).all()) and float(err.max()) <= BF16_MAX_ERR and float(
            err.mean()) <= BF16_MEAN_ERR
        say(f"{label} [{name}]: prologue equal to the plain one (q_i8, k_i8, alpha) {same}; max abs err "
            f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}")
        if not ok and name not in UNCHECKED:
            raise RuntimeError(f"{label} [{name}] disagrees with the plain version")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="a directory for each build's whole nvcc output")
    parser.add_argument("names", nargs="*", help="variants to run (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_sm90_variants.py runs on a CUDA card")
    names = args.names or list(VARIANTS)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = vb.card()
    libs = build(names, args.out)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, entry, b, n, timed in CASES:
        case = Case(gen, entry, b, n)
        for name, lib in libs.items():
            case.call(lib, 3, stream)
            case.check(name, label)
        if not timed:
            continue
        calls = {}
        if entry == 7:
            views = [t.transpose(1, 2) for t in case.qkv.view(b, n, HEADS, 3, D).unbind(3)]
            calls["SDPA"] = lambda: F.scaled_dot_product_attention(*views)
            calls["#1"] = lambda: fa.flash_attention_fused_qkv(case.qkv, HEADS)
        else:
            calls["SDPA"] = lambda: F.scaled_dot_product_attention(*(t[None] for t in case.qkv))
        for name, lib in libs.items():
            for stages, part in ((3, "entry"), (1, "prologue"), (2, "attention")):
                calls[(name, part)] = lambda lib=lib, stages=stages: case.call(lib, stages, stream)
        first = {key: ft.device_ms(fn) for key, fn in calls.items()}
        second = {key: ft.device_ms(fn) for key, fn in reversed(calls.items())}
        best = {key: min(first[key], second[key]) for key in calls}
        yard = ", ".join(f"{key} {best[key]:.4f}" for key in ("SDPA", "#1") if key in best)
        say(f"{label} (N={n}) bf16: device ms per call (20 queued behind a spin, after 3; two turns, the faster kept), "
            f"entry / prologue / attention; {yard} [{smi}]")
        for name in libs:
            say(f"  {name:22s} {best[(name, 'entry')]:.4f} / {best[(name, 'prologue')]:.4f} / "
                f"{best[(name, 'attention')]:.4f}")
        del case, calls
        torch.cuda.empty_cache()
    if args.out:
        with open(os.path.join(args.out, "int8_sm90_variants.txt"), "w") as f:
            f.write("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
