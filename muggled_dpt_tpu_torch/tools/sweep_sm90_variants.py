#!/usr/bin/env python3
"""Design variants of the attention sweep's sm_90 kernels, #10
(``csrc/flash_xl_sm90.cu``) and #11 (``csrc/flash_staged_sm90.cu``), timed on
the card.

    python3 muggled_dpt_tpu_torch/tools/sweep_sm90_variants.py [--out DIR] [NAME ...]

Each variant is a source as committed with one design decision changed by a
text edit, built by ``variant_build.py`` (nvcc with ``-Xptxas=-v``) into a
library of its own (under the gitignored ``build/sweep_variants/``, with
``csrc/`` on the include path) with a C entry over raw pointers, all builds
started together. For each variant it prints the build's seconds and, per
kernel, ptxas's registers and spills and any wgmma serialization warning
(C75xx); ``--out DIR`` writes each build's whole output to ``DIR/sweep_variant_<n>.txt``. Then it
times each variant's cases with CUDA events (median of 10 launches after 2,
in two turns, forward then backward, the faster kept) on a random
(1, 18497, 3072) bf16 slab from the seed, DA-V2 ViT-L's 1904x1904 token
count with 16 heads of 64, beside #1 and SDPA on the same slab, and compares
each output that computes attention with #1's plain version (the ablations'
outputs are not compared). Cases: #10 in every (qp, pipelined, mode) of
``flash_tune.XL_CASES`` and the sm_90 source's other instantiations; #11 at
the panel width of 2 panels. ``NAME ...`` limits the run to those variants.
Variants:
  * ``xl`` and ``staged``: as committed;
  * ``xl 3 stages``: a 3-stage K/V ring at 128-key tiles (qp=1 then holds
    2 CTAs per SM in 208 KB of shared memory);
  * ``xl trap``, ``staged trap``: the waits on the mbarriers bounded by
    the clock, with a trap past about 18 s (the window kernel's wait);
  * ``xl no branch``: the pipelined loop's softmax without run-time
    branches while a wgmma is in flight: no mask (the loop's tiles are
    whole), no negative-scale path (the tool's scale is positive);
  * ``xl PV last``: the pipelined step issues tile t+1's QK^T with PV_{t-1}
    still in flight and waits for PV_{t-1} after the softmax (two wgmma
    groups in flight under it, one of them issued in the step before);
  * ``staged fold branch``: pass 1 folds a panel's max into the row's
    under a branch at the panel's last tile, not by a select at every tile;
  * ``staged 2 K stages``: pass 1's K ring 2 stages deep, not 4;
  * ``staged pass 1 waits``: pass 1 waits for tile t+1's QK^T before tile
    t's max (two S arrays, no product in flight under the max);
  * ``staged QK^T across the loop``: pass 1 one tile per step, tile t+1's
    QK^T issued in step t and retired in step t+1 (in flight across the
    loop's back edge), every tile's max masked;
  * ``staged pass 2 only`` (ablation): no pass 1, m = 0: the time of pass 2
    alone (its output is not an attention).
Runs only on a CUDA card; every line carries the card's name and power
limit."""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys

import torch
import torch.nn.functional as F

if __name__ == "__main__":  # run as a script: the package of this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels._build import CSRC_DIR  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels.flash_attention_staged import _panel_bounds  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels.flash_attention_xl import ablation_reference  # noqa: E402
from muggled_dpt_tpu_torch.tools import flash_tune as ft  # noqa: E402
from muggled_dpt_tpu_torch.tools import variant_build as vb  # noqa: E402

HEADS, HEAD_DIM, N = 16, 64, 18497
XL, STAGED = "flash_xl_sm90.cu", "flash_staged_sm90.cu"
ENTRY = {
    XL: r"""
extern "C" int run(const void* q, const void* k, const void* v, void* o, const long long* st_in, const long long* st_out,
                   int batch, int n, int heads, int qp, int pipelined, int ablate, int panel, float scale_log2, void* stream) {
    return (int)flash_xl_sm90(q, st_in, k, st_in, v, st_in, o, st_out, batch, n, heads, qp, pipelined, ablate, scale_log2,
                              (cudaStream_t)stream);
}
""",
    STAGED: r"""
extern "C" int run(const void* q, const void* k, const void* v, void* o, const long long* st_in, const long long* st_out,
                   int batch, int n, int heads, int qp, int pipelined, int ablate, int panel, float scale_log2, void* stream) {
    return (int)flash_staged_sm90(q, st_in, k, st_in, v, st_in, o, st_out, batch, n, heads, panel, scale_log2,
                                  (cudaStream_t)stream);
}
""",
}
XL_INSTANCES = [(qp, pipelined, ablate) for qp in (1, 2, 4) for pipelined in (0, 1) for ablate in (0, 1)]
K1 = "const int k1 = tiles + (tiles & 1);"
# the window kernel's wait: a clock bound, then a trap (a launch failure the caller sees) rather than a hang
TRAP = [("mbar_wait(", "wait_phase("), ("struct VParams {", r"""constexpr long long WAIT_LIMIT = 1ll << 35;
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return done != 0;
}
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
    if (mbar_try(bar, parity)) return;
    const long long start = clock64();
    while (!mbar_try(bar, parity))
        if (clock64() - start > WAIT_LIMIT) __trap();
}
struct VParams {""")]
# #11's pass 1 as first written: tile t+1's QK^T issued in step t and retired in step t+1, across the loop's back edge
PASS1_START = "// Pass 1 over every key tile, two at a time"
PASS1_ACROSS = r"""template <bool NEG>
__device__ __forceinline__ void max_step(Smem& sm, float (&cur)[64], float (&nxt)[64], float (&mp)[2], float (&mx)[2],
                                         uint64_t dq, int t, int& panel_end, int panel_tiles, int n, int lane, int c) {
    mbar_wait(&sm.full_k[stage_of<KSTAGES>(t + 1)], parity_of<KSTAGES>(t + 1));
    fence_regs(nxt);
    wgmma_fence();
    issue_qk(nxt, dq, sm.k[stage_of<KSTAGES>(t + 1)]);
    wgmma_commit();
    wgmma_wait<1>();  // QK^T_t, issued in the step before
    fence_regs(cur);
    release(&sm.empty_k[stage_of<KSTAGES>(t)], lane);
    fold_max<NEG, true>(cur, mp, mx, t, panel_end, panel_tiles, n, c);
}

template <bool NEG>
__device__ __forceinline__ void pass1(Smem& sm, float (&mx)[2], uint64_t dq, int tiles, int panel_tiles, int n, int lane, int c) {
    float sa[64], sb[64];
    for (int i = 0; i < 64; ++i) sa[i] = sb[i] = 0.f;
    float mp[2] = {-INFINITY, -INFINITY};
    int panel_end = panel_tiles;
    const int pairs = (tiles + 1) / 2;
    mbar_wait(&sm.full_k[0], 0);
    wgmma_fence();
    issue_qk(sa, dq, sm.k[0]);
    wgmma_commit();
    for (int t = 0; t < 2 * pairs - 2; t += 2) {
        max_step<NEG>(sm, sa, sb, mp, mx, dq, t, panel_end, panel_tiles, n, lane, c);
        max_step<NEG>(sm, sb, sa, mp, mx, dq, t + 1, panel_end, panel_tiles, n, lane, c);
    }
    const int t = 2 * pairs - 2;
    max_step<NEG>(sm, sa, sb, mp, mx, dq, t, panel_end, panel_tiles, n, lane, c);
    wgmma_wait<0>();
    fence_regs(sb);
    release(&sm.empty_k[stage_of<KSTAGES>(t + 1)], lane);
    fold_max<NEG, true>(sb, mp, mx, t + 1, panel_end, panel_tiles, n, c);
    for (int r = 0; r < 2; ++r) {
        mp[r] = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 1));
        mp[r] = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 2));
        mx[r] = fmaxf(mx[r], mp[r]);
    }
}
"""


def committed_function(source: str, start: str) -> str:
    """The text of the function that follows the comment line ``start`` in csrc/``source``, comment included."""
    text = (CSRC_DIR / source).read_text()
    i = text.index(start)
    return text[i:text.index("\n}\n", i) + 3]


# the loops' softmax / max without run-time branches: no mask (their tiles are whole), no negative scale (the tool's is positive)
NO_NEG = [("""    if (scale_log2 >= 0.f) {
        row_max<MASK, false>(s, mx, kbase, n, c);
    } else {
        row_max<MASK, true>(s, mx, kbase, n, c);
    }""", "    row_max<MASK, false>(s, mx, kbase, n, c);")]
VARIANTS = {  # name: (source, text replacements, ablation: its output is not compared)
    "xl": (XL, [], False),
    "xl trap": (XL, TRAP, False),
    "xl 3 stages": (XL, [("static constexpr int STAGES = BKV == 128 ? 2 : 4;",
                          "static constexpr int STAGES = BKV == 128 ? 3 : 4;")], False),
    "xl PV last": (XL, [("    wgmma_wait<0>();  // PV_{t-1}\n    fence_regs(o);\n    if (t > 0) release(&sm.empty_v[stage_of<S>(t - 1)], lane);\n", ""),
                        ("    if constexpr (MODE == XL_FLASH) rescale(o, alpha);\n    pack_p(p, cur);\n",
                         "    wgmma_wait<1>();  // PV_{t-1}\n    fence_regs(o);\n    if (t > 0) release(&sm.empty_v[stage_of<S>(t - 1)], lane);\n"
                         "    if constexpr (MODE == XL_FLASH) rescale(o, alpha);\n    pack_p(p, cur);\n")], False),
    "xl no branch": (XL, NO_NEG + [("    weights<MODE>(cur, m, l, alpha, scale_log2, t * Shape::BKV, n, c);",
                                    "    if constexpr (MODE == XL_FLASH) online_softmax<false>(cur, m, l, alpha, scale_log2, t * Shape::BKV, n, c);\n"
                                    "    else weights<MODE>(cur, m, l, alpha, scale_log2, t * Shape::BKV, n, c);")], False),
    "staged": (STAGED, [], False),
    "staged trap": (STAGED, TRAP, False),
    "staged QK^T across the loop": (STAGED, [(committed_function(STAGED, PASS1_START), PASS1_ACROSS)], False),
    "staged fold branch": (STAGED, [("""    const bool last = t + 1 == panel_end;  // the panel's last tile
    panel_end += last ? panel_tiles : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float q = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 1));
        q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, 2));
        mx[r] = last ? fmaxf(mx[r], q) : mx[r];
        mp[r] = last ? -INFINITY : mp[r];
    }""", """    if (t + 1 == panel_end) {
        panel_end += panel_tiles;
        for (int r = 0; r < 2; ++r) {
            mp[r] = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 1));
            mp[r] = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 2));
            mx[r] = fmaxf(mx[r], mp[r]);
            mp[r] = -INFINITY;
        }
    }""")], False),
    "staged 2 K stages": (STAGED, [("constexpr int KSTAGES = 4, VSTAGES = 2;", "constexpr int KSTAGES = 2, VSTAGES = 2;")],
                          False),
    "staged pass 1 waits": (STAGED, [("    wgmma_wait<1>();  // QK^T_t\n", "    wgmma_wait<0>();  // QK^T_t\n")], False),
    "staged pass 2 only": (STAGED, [("    pass1<NEG>(sm, mx, dq, tiles, a.panel_tiles, n, lane, c);\n",
                                     "    mx[0] = mx[1] = 0.f;\n"), (K1, "const int k1 = 0;")], True),
}


HEADER = "flash_variants_sm90.cuh"
RUN_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def variant_source(source: str, replacements) -> str:
    """The source with flash_variants_sm90.cuh inlined, the edits applied and the raw C entry appended."""
    return vb.edited(vb.with_header(source, HEADER), replacements, f"csrc/{source}") + ENTRY[source]


def kernel_label(mangled: str) -> str:
    """fxl_sm90<qp, pipelined, mode> or fst_sm90 from a mangled kernel name."""
    m = re.search(r"fxl_sm90ILi(\d)ELb(\d)ELi(\d)E", mangled)
    if m:
        return f"fxl_sm90<qp={m.group(1)}, pipelined={m.group(2)}, {'ablate' if m.group(3) == '1' else 'flash'}>"
    return "fst_sm90" if "fst_sm90" in mangled else mangled[:60]


def ptxas_summary(log: str) -> list[str]:
    """``variant_build.ptxas_summary`` with this tool's kernel names."""
    return vb.ptxas_summary(log, kernel_label)


def build(names, out_dir) -> dict:
    """Every variant compiled at once, one nvcc each; returns {name: library}."""
    sources = {name: variant_source(*VARIANTS[name][:2]) for name in names}
    return vb.build(sources, "sweep_variants", dict.fromkeys(names, RUN_ARGS), out_dir, "sweep_variant", kernel_label)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="a directory for each build's whole nvcc output")
    parser.add_argument("names", nargs="*", help="variants to run (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_sm90_variants.py runs on a CUDA card")
    names = args.names or list(VARIANTS)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = vb.card()
    libs = build(names, args.out)
    gen = torch.Generator(device="cuda").manual_seed(0)
    c3 = 3 * HEADS * HEAD_DIM
    qkv = torch.randn(1, N, c3, device="cuda", dtype=torch.bfloat16, generator=gen)
    out = torch.empty(1, N, HEADS * HEAD_DIM, device="cuda", dtype=torch.bfloat16)
    st_in = (ctypes.c_longlong * 3)(N * c3, c3, 3 * HEAD_DIM)
    st_out = (ctypes.c_longlong * 3)(N * HEADS * HEAD_DIM, HEADS * HEAD_DIM, HEAD_DIM)
    ptr, es = qkv.data_ptr(), qkv.element_size()
    scale_log2 = HEAD_DIM**-0.5 * fa.LOG2E
    panel = _panel_bounds((N + 127) // 128 * 128, 2)[1]
    stream = torch.cuda.current_stream().cuda_stream
    ref = fa.flash_attention_fused_qkv_reference(qkv, HEADS).float()
    ablation = ablation_reference(qkv, HEADS).float()
    sdpa = [t.transpose(1, 2) for t in qkv.unflatten(2, (HEADS, 3, HEAD_DIM)).unbind(3)]
    calls = {"#1 (flash_attention_sm90.cu)": lambda: fa.flash_attention_fused_qkv(qkv, HEADS),
             "SDPA": lambda: F.scaled_dot_product_attention(*sdpa)}
    checks = {}
    for name, lib in libs.items():
        source, _, is_ablation = VARIANTS[name]
        instances = XL_INSTANCES if source == XL else [(1, 0, 0)]
        for qp, pipelined, ablate in instances:
            label = f"{name}: " + (f"qp={qp} {'pipelined' if pipelined else 'seq'}{' ablate' if ablate else ''}"
                                   if source == XL else "panels=2")
            call = (lambda lib=lib, qp=qp, pipelined=pipelined, ablate=ablate:
                    lib.run(ptr, ptr + HEAD_DIM * es, ptr + 2 * HEAD_DIM * es, out.data_ptr(), st_in, st_out, 1, N, HEADS,
                            qp, pipelined, ablate, panel, scale_log2, stream))
            err = call()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{label}: launch failed, CUDA error {err}")
            if not is_ablation:
                want = ablation if ablate else ref
                diff = float((out.float() - want).abs().max())
                checks[label] = diff
                if not diff <= 2e-2 * max(1.0, float(want.abs().max())):
                    raise RuntimeError(f"{label} disagrees with its plain version: max abs difference {diff:.3e}")
            calls[label] = call
    first = {label: ft.time_ms(fn, 10, 2) for label, fn in calls.items()}
    second = {label: ft.time_ms(fn, 10, 2) for label, fn in reversed(calls.items())}
    anchor = min(first["#1 (flash_attention_sm90.cu)"], second["#1 (flash_attention_sm90.cu)"])
    flops = 4 * HEADS * N * N * HEAD_DIM
    print(f"B=1 N={N} H={HEADS} D={HEAD_DIM} bf16 random slab (median of 10 after 2, two turns) [{smi}]", flush=True)
    for label in calls:
        ms = min(first[label], second[label])
        vs = f"; max abs difference from the plain version {checks[label]:.3e}" if label in checks else ""
        print(f"  {label:40s} {ms:9.4f} ms  {flops / ms / 1e9:5.0f} TFLOP/s  {ms / anchor:5.2f}x #1{vs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
