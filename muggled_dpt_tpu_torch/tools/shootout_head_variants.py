#!/usr/bin/env python3
"""Design variants of the attention shoot-out's sm_90 kernel, #12
(``csrc/flash_variant_sm90.cu``), and of the head tail's, #9
(``csrc/head_tail_sm90.cu``), timed on the card.

    python3 muggled_dpt_tpu_torch/tools/shootout_head_variants.py [--out DIR] [NAME ...]

Each variant is a source as committed with one design decision changed by a
text edit, built by ``variant_build.py`` (nvcc with ``-Xptxas=-v``) into a
library of its own (under the gitignored ``build/shootout_head_variants/``, with
``csrc/`` on the include path) with a C entry over raw pointers, all builds
started together.
For each variant it prints the build's seconds and, per kernel, ptxas's
registers and spills and any wgmma serialization warning (C75xx); ``--out
DIR`` writes each build's whole output to ``DIR/shootout_head_variant_<n>.txt``.
Each variant's output is held against its plain version, then timed.
Times: device time per launch, the launches queued back to back behind a
spin of the card (``flash_tune.device_ms``) so that the host's cost per
call does not show, mean of 20 after 3 warm-ups, in two turns (forward, then
backward), the faster kept; beside them SDPA (#12) or ``Head.tail``'s
composite, cuDNN conv3x3 -> ReLU -> conv1x1 -> ReLU (#9), timed the same way.
Variants:
  * ``fv height 1``, ``fv height 2``, ``fv height 3``: #12 with 64, 128 or
    192 q rows per CTA (1, 2 or 3 consumer warpgroups), every mode of
    ``flash_tune.VARIANT_CASES`` at the JAX tool's (16, 1297, 64) and at
    (16, 18497, 64), the 1904x1904 ladder slab's heads, random from the seed;
  * ``ht``: #9 as committed, at (B, 128, 504, 504), B = 1 and 8, ReLU;
  * ``ht no copies`` (not the conv: its output is not held): the dx = 0 and
    2 products read the centre box, no shifted copies made: the time of
    the loads and the products alone;
  * ``ht 6 rows``, ``ht 4 rows``: 6 or 4 output rows per unit at ci = 128,
    not 8;
  * ``ht unaligned box``: the centre box at column x0 - 1 (design (a)'s
    box for dx = 0). TMA faults on it (an illegal instruction, which ends
    the process's CUDA context): run it alone, last.
Runs only on a CUDA card; every line carries the card's name and power
limit."""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import sys

import numpy as np
import torch
import torch.nn.functional as F

if __name__ == "__main__":  # run as a script: the package of this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from muggled_dpt_tpu_torch.ops.kernels import head_tail as ht  # noqa: E402
from muggled_dpt_tpu_torch.tools import attn_variants as fav  # noqa: E402
from muggled_dpt_tpu_torch.tools import flash_tune as ft  # noqa: E402
from muggled_dpt_tpu_torch.tools import variant_build as vb  # noqa: E402

FV, HT = "flash_variant_sm90.cu", "head_tail_sm90.cu"
HEADER = "flash_variants_sm90.cuh"
ENTRY = {
    FV: r"""
extern "C" int run(const void* q, const void* k, const void* v, void* o, const long long* st, int batch, int n, int kend,
                   int mode, float scale_log2, void* stream) {
    return (int)flash_variant_sm90(q, st, k, st, v, st, o, st, batch, n, 1, kend, mode, scale_log2, (cudaStream_t)stream);
}
""",
    HT: r"""
extern "C" int run(const void* x, const void* conv_w, const void* conv_b, const void* proj_w, const void* proj_b, void* out,
                   int batch, int ci, int h, int w, int is_metric, void* stream) {
    return (int)head_tail_sm90(x, conv_w, conv_b, proj_w, proj_b, out, batch, ci, h, w, is_metric != 0, (cudaStream_t)stream);
}
""",
}
FV_MODES = {"mask_exp": 0, "mask_exp2": 0, "padfix": 1, "nosm": 2, "exponly": 3, "maxonly": 4}  # FvMode
FV_SHAPES = ((16, 1297), (16, 18497))  # (BH, N), D = 64
HT_SHAPES = ((1, 128, 504, 504), (8, 128, 504, 504))  # (B, ci, H, W)
HEIGHT = "constexpr int HEIGHT = 3;"
FV_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
HT_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def height(qp: int) -> list:
    return [(HEIGHT, f"constexpr int HEIGHT = {qp};")]


VARIANTS = {  # name: (source, text replacements)
    "fv height 1": (FV, height(1)),
    "fv height 2": (FV, height(2)),
    "fv height 3": (FV, height(3)),
    "ht": (HT, []),
    "ht no copies": (HT, [("""        const uint8_t* src[3] = {shifted + (idx & 1) * 2 * BOX_BYTES<ROWS>, ring + st * STAGE_BYTES<ROWS>,
                                 shifted + (idx & 1) * 2 * BOX_BYTES<ROWS> + BOX_BYTES<ROWS>};  // dx = 0, 1, 2""",
                           """        const uint8_t* src[3] = {ring + st * STAGE_BYTES<ROWS>, ring + st * STAGE_BYTES<ROWS>,
                                 ring + st * STAGE_BYTES<ROWS>};"""),
                          ("            shift_copies<ROWS>(ring + next * STAGE_BYTES<ROWS>, set, set + BOX_BYTES<ROWS>, t);\n", "")]),
    "ht 6 rows": (HT, [("constexpr int ROWS_WIDE = 8,", "constexpr int ROWS_WIDE = 6,")]),
    "ht 4 rows": (HT, [("constexpr int ROWS_WIDE = 8,", "constexpr int ROWS_WIDE = 4,")]),
    "ht unaligned box": (HT, [("tma_load(stage, &tx, &full[st], x0, kc * CH, y0 - 1, b);",
                               "tma_load(stage, &tx, &full[st], x0 - 1, kc * CH, y0 - 1, b);")]),
}
UNCHECKED = ("ht no copies", "ht unaligned box")  # not the conv: timed, not held against the plain version


def variant_source(source: str, replacements) -> str:
    """The source with flash_variants_sm90.cuh inlined, the edits applied and the raw C entry appended."""
    return vb.edited(vb.with_header(source, HEADER), replacements, f"csrc/{source}") + ENTRY[source]


def kernel_label(mangled: str) -> str:
    """fv_sm90<height, mode> or ht_sm90 from a mangled kernel name."""
    m = re.search(r"fv_sm90ILi(\d)ELi(\d)E", mangled)
    return f"fv_sm90<{m.group(1)}, {m.group(2)}>" if m else "ht_sm90" if "ht_sm90" in mangled else mangled[:60]


def build(names, out_dir) -> dict:
    """Every variant compiled at once, one nvcc each; returns {name: library}."""
    sources = {name: variant_source(*VARIANTS[name]) for name in names}
    argtypes = {name: FV_ARGS if VARIANTS[name][0] == FV else HT_ARGS for name in names}
    return vb.build(sources, "shootout_head_variants", argtypes, out_dir, "shootout_head_variant", kernel_label)


def turns(calls: dict) -> dict:
    """Each call's device time in two turns, forward then backward, the faster kept."""
    first = {label: ft.device_ms(fn) for label, fn in calls.items()}
    second = {label: ft.device_ms(fn) for label, fn in reversed(calls.items())}
    return {label: min(first[label], second[label]) for label in calls}


def fv_cases(libs, rng, stream) -> dict:
    """#12's height variants on every mode at FV_SHAPES, held against the plain version; {label: call}."""
    calls = {}
    for g, n in FV_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((g, n, 64), dtype=np.float32)).cuda() for _ in range(3))
        q_s, q_s2 = (q * 0.125).bfloat16(), (q * (0.125 * math.log2(math.e))).bfloat16()
        k, v = k.bfloat16(), v.bfloat16()
        out = torch.empty_like(k)
        st = (ctypes.c_longlong * 3)(n * 64, 64, 64)
        n_pad = (n + 127) // 128 * 128
        calls[f"({g}, {n}, 64) SDPA"] = lambda q=q_s2, k=k, v=v: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                                                                scale=math.log(2.0))
        for name, lib in libs.items():
            for case, kw in ft.VARIANT_CASES:
                mode = kw.get("mode", "padfix")
                qq = q_s if mode == "mask_exp" else q_s2
                kend = n if mode.startswith("mask") else n_pad // kw["chunk"] * kw["chunk"] if "chunk" in kw else n_pad
                if kend > n_pad or kend < 1:
                    continue
                scale = math.log2(math.e) if mode == "mask_exp" else 1.0
                call = (lambda lib=lib, qq=qq, k=k, v=v, out=out, st=st, g=g, n=n, kend=kend, m=FV_MODES[mode], scale=scale:
                        lib.run(qq.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st, g, n, kend, m, scale, stream))
                label = f"({g}, {n}, 64) {case} [{name}]"
                if call() != 0:
                    raise RuntimeError(f"{label}: launch failed")
                if n <= 1297 or case == "v3 padfix":
                    want = fav.flash_variant_reference(qq, k, v, mode, kw.get("chunk")).float()
                    finite = torch.isfinite(want)
                    got = out.float()
                    diff = float((got - want).abs()[finite].max())
                    if not torch.equal(torch.isfinite(got), finite) or diff > 2e-2 * max(1.0, float(want[finite].abs().max())):
                        raise RuntimeError(f"{label} disagrees with its plain version: max abs difference {diff:.3e}")
                calls[label] = call
    return calls


def ht_cases(libs, rng, stream) -> dict:
    """#9's variants at HT_SHAPES, held against the plain version; {label: call}."""
    calls = {}
    for b, ci, h, w in HT_SHAPES:
        mk = lambda shape, scale, shift: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)).cuda().bfloat16()
        x = mk((b, ci, h, w), 1.0, 0.0)
        p = [mk((32, ci, 3, 3), (9 * ci) ** -0.5, 0.0), mk((32,), 0.1, 0.0), mk((1, 32, 1, 1), 0.3, 0.0), mk((1,), 1.0, 2.0)]
        out = torch.empty((b, h, w), dtype=torch.bfloat16, device="cuda")
        want = ht.fused_head_tail_reference(x, *p).float()
        calls[f"({b}, {ci}, {h}, {w}) composite"] = (
            lambda x=x, p=p: F.relu(F.conv2d(F.relu(F.conv2d(x, p[0], p[1], padding=1)), p[2], p[3])))
        for name, lib in libs.items():
            call = (lambda lib=lib, x=x, p=p, out=out, b=b, ci=ci, h=h, w=w:
                    lib.run(x.data_ptr(), *(t.data_ptr() for t in p), out.data_ptr(), b, ci, h, w, 0, stream))
            label = f"({b}, {ci}, {h}, {w}) [{name}]"
            if call() != 0:
                raise RuntimeError(f"{label}: launch failed")
            torch.cuda.synchronize()
            diff = float((out.float() - want).abs().max())
            if not diff <= 1.6e-2 * float(want.abs().max()) and name not in UNCHECKED:
                raise RuntimeError(f"{label} disagrees with its plain version: max abs difference {diff:.3e}")
            print(f"{label}: max abs difference from the plain version {diff:.3e}", flush=True)
            calls[label] = call
    return calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="a directory for each build's whole nvcc output")
    parser.add_argument("names", nargs="*", help="variants to run (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("shootout_head_variants.py runs on a CUDA card")
    names = args.names or list(VARIANTS)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = vb.card()
    libs = build(names, args.out)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    groups = (("#12", {k: v for k, v in libs.items() if VARIANTS[k][0] == FV}, fv_cases),
              ("#9", {k: v for k, v in libs.items() if VARIANTS[k][0] == HT}, ht_cases))
    for kid, group, cases in groups:
        if not group:
            continue
        times = turns(cases(group, rng, stream))
        print(f"{kid} device time per launch (mean of 20 queued behind a spin, after 3; two turns) [{smi}]", flush=True)
        for label, ms in times.items():
            print(f"  {label:60s} {ms:9.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
