#!/usr/bin/env python3
"""Design variants of the fused LayerNorm-MLP-residual's sm_90 kernels, #8
(``csrc/fused_mlp_sm90.cu``), timed on the card.

    python3 muggled_dpt_tpu_torch/tools/mlp_sm90_variants.py [--out DIR] [NAME ...]

Each variant is the source as committed with its schedule constants
(``FC1_BN``, ``FC1_PINGPONG``, ``FC2_BN``, ``FC2_PINGPONG``, ``EPI_CHUNK``)
set, or a piece of its code changed, by a text edit, built by ``variant_build.py`` (nvcc with ``-Xptxas=-v``)
into a library of its own (under the gitignored ``build/mlp_sm90_variants/``,
with ``csrc/`` on the include path) with a C entry over raw pointers, all
builds started together. For each variant it prints the build's seconds
and, per kernel, ptxas's registers and spills and any wgmma serialization
warning (C75xx); ``--out DIR`` writes each build's whole output to
``DIR/mlp_sm90_variant_<n>.txt``. Each variant's output is held against the
plain version (``fused_ln_mlp_residual_reference``) at every shape of
``SHAPES``, then timed at the ViT-L ones: the whole call as device time
(``flash_tune.device_ms``: 20 calls queued behind a spin of the card, mean
after 3 warm-ups, two turns, the faster kept) and each of its three kernels
from CUDA events the C entry records between their launches (median of 5
calls); beside them the composite of ``Block.mlp_residual`` (LayerNorm,
fc1, GELU, fc2, LayerScale and residual as separate bf16 ops), timed the
same way. Inputs: random from the seed, as ``chip_smoke.py:mlp_inputs``.
Variants (cooperative: both consumer warpgroups on one 128-row tile;
ping-pong: each on 128 x 128 tiles of its own):
  * ``committed``: the source as it is (fc1 cooperative on 128 x 256
    tiles, fc2 cooperative on 128 x 128, 4 blocks of 8 columns at a time
    in the epilogue);
  * ``fc1 coop 128``, ``fc1 pingpong 128``: fc1 on 128 x 128 tiles;
  * ``fc2 coop 256``, ``fc2 pingpong 128``: fc2 on 128 x 256 tiles, or
    ping-pong on 128 x 128;
  * ``both pingpong 128``: the two ping-pong;
  * ``chunk 1``, ``chunk 2``, ``chunk 8``, ``chunk 16``: the epilogue's
    columns 1, 2, 8 or 16 blocks of 8 at a time, not 4;
  * ``pipelined``: a K slab's wgmma group kept in flight while the next is
    issued (the wait retires the slab before, whose stage is then
    released), not retired before it;
  * ablations, timed but not held against the plain version (their output
    is not the function's): ``no gelu`` (fc1's epilogue without the erff
    GELU), ``no stores`` (both epilogues without their stores, the values
    kept alive by a store under a condition that never holds), ``epilogue
    sum only`` (each epilogue replaced by a sum of the accumulators),
    ``mainloop only`` (both GEMMs without their epilogues: the loads and
    products alone), ``no bias loads`` (the epilogues' bias pairs 0, not
    loaded), ``pingpong mainloop only`` and ``pingpong epilogue sum
    only`` (the same two on both GEMMs' ping-pong schedule);
  * ``gelu noinline``: the GELU a called function, not inlined (the
    epilogue's code 128 erff shorter).
A variant equal to the committed source is built all the same. ``--out
DIR`` also writes every line printed after the builds to
``DIR/mlp_sm90_variants.txt``. Runs only on a CUDA card; every table
carries the card's name and power limit."""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

if __name__ == "__main__":  # run as a script: the package of this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from muggled_dpt_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels._build import CSRC_DIR  # noqa: E402
from muggled_dpt_tpu_torch.tools import flash_tune as ft  # noqa: E402
from muggled_dpt_tpu_torch.tools import variant_build as vb  # noqa: E402

SOURCE = "fused_mlp_sm90.cu"
ENTRY = r"""
extern "C" int run(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* ls, void* out, void* xn, void* g, int rows, int f, int hidden, float eps,
                   void* const* events, void* stream) {
    return (int)fused_mlp_sm90(x, ln_w, ln_b, w1, b1, w2, b2, ls, out, xn, g, rows, f, hidden, eps, events, (cudaStream_t)stream);
}
"""
ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
VITL_ROWS = (8 * 1297, 1297)  # DA ViT-L at 504x504, B = 8 and 1
SHAPES = tuple((rows, 1024, 4096) for rows in VITL_ROWS) + ((100, 384, 1568),)  # (rows, F, H); the last checked only
REL_MAX, REL_MEAN = 1.6e-2, 2e-3  # chip_smoke.py's BF16_REL_MAX, BF16_REL_MEAN

GELU_CALLS = """                        y0 = gelu_erf(y0);
                        y1 = gelu_erf(y1);
"""
EPILOGUE_CALL = "            epilogue<EPI, BN, MT>(acc, p, buf, row0, n0, warp, lane);\n"
STORE = "                    if (row < p.rows && 8 * i < cols) *reinterpret_cast<uint32_t*>(out + 8 * i) = v;\n"
NO_STORE = "                    if (v == 0x12345678u) *reinterpret_cast<uint32_t*>(out + 8 * i) = v;\n"
SUM_ONLY = ("            { float s = 0.f; _Pragma(\"unroll\") for (int mt = 0; mt < MT; ++mt) _Pragma(\"unroll\") for (int i = 0; i < BN / 2; "
            "++i) s += acc[mt][i]; if (s == 1.25e-30f) p.out[threadIdx.x] = __float2bfloat16(s); }\n")
GELU_INLINE = "__device__ __forceinline__ float gelu_erf(float h)"
BIAS_LOAD = "return {in ? ldg_u32(p.bias + n0 + 2 * t) : 0u,"
PINGPONG = {"FC1_BN": 128, "FC1_PINGPONG": True, "FC2_BN": 128, "FC2_PINGPONG": True}
PIPELINED_EDITS = [  # mainloop: wait for the slab before, release its stage; after the loop retire the last one
    ("""        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        release(&empty[st], lane);
    }
    if (passed != nullptr) release(passed, lane);
""", """        wgmma_wait<1>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        if (ks > 0) release(&empty[(idx - 1) % S], lane);
    }
    if (passed != nullptr) release(passed, lane);
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    release(&empty[(idx - 1) % S], lane);
""")]
VARIANTS = {  # name: ({constant: value}, text edits)
    "committed": ({}, []),
    "fc1 coop 128": ({"FC1_BN": 128, "FC1_PINGPONG": False}, []),
    "fc1 pingpong 128": ({"FC1_BN": 128, "FC1_PINGPONG": True}, []),
    "fc2 coop 256": ({"FC2_BN": 256, "FC2_PINGPONG": False}, []),
    "fc2 pingpong 128": ({"FC2_BN": 128, "FC2_PINGPONG": True}, []),
    "both pingpong 128": (PINGPONG, []),
    "chunk 1": ({"EPI_CHUNK": 1}, []),
    "chunk 2": ({"EPI_CHUNK": 2}, []),
    "chunk 8": ({"EPI_CHUNK": 8}, []),
    "chunk 16": ({"EPI_CHUNK": 16}, []),
    "pipelined": ({}, PIPELINED_EDITS),
    "no gelu": ({}, [(GELU_CALLS, "")]),
    "gelu noinline": ({}, [(GELU_INLINE, "__device__ __noinline__ float gelu_erf(float h)")]),
    "no stores": ({}, [(STORE, NO_STORE)]),
    "epilogue sum only": ({}, [(EPILOGUE_CALL, SUM_ONLY)]),
    "mainloop only": ({}, [(EPILOGUE_CALL, "")]),
    "no bias loads": ({}, [(BIAS_LOAD, "return {0u,")]),
    "pingpong mainloop only": (PINGPONG, [(EPILOGUE_CALL, "")]),
    "pingpong epilogue sum only": (PINGPONG, [(EPILOGUE_CALL, SUM_ONLY)]),
}
UNCHECKED = ("no gelu", "no stores", "epilogue sum only", "mainloop only", "no bias loads", "pingpong mainloop only",
             "pingpong epilogue sum only")  # ablations: timed, not held against the plain version
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
    """mlp_ln_sm90, mlp_fc1_sm90<BN, pingpong> or mlp_fc2_sm90<..> from a mangled kernel name."""
    m = re.search(r"(mlp_fc[12]_sm90)ILi(\d+)ELb([01])E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}, {'pingpong' if m.group(3) == '1' else 'coop'}>"
    return "mlp_ln_sm90" if "mlp_ln_sm90" in mangled else mangled[:60]


def build(names, out_dir) -> dict:
    """Every variant compiled at once, one nvcc each; returns {name: library}."""
    sources = {name: variant_source(*VARIANTS[name]) for name in names}
    return vb.build(sources, "mlp_sm90_variants", {name: ARGS for name in names}, out_dir, "mlp_sm90_variant", kernel_label)


def inputs(rng, rows, f, hidden):
    """Tokens N(0, 1) and norm2, fc1, fc2 and ls2 in torch layout, bf16 on the
    card: fc1 and fc2 scaled by 1/sqrt(fan-in) (chip_smoke.py's mlp_inputs)."""
    def mk(shape, scale, shift):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)).cuda().bfloat16()

    params = [mk((f,), 0.05, 1.0), mk((f,), 0.05, 0.0), mk((hidden, f), f**-0.5, 0.0), mk((hidden,), 0.05, 0.0),
              mk((f, hidden), hidden**-0.5, 0.0), mk((f,), 0.05, 0.0), mk((f,), 0.05, 1.0)]
    return mk((rows, f), 1.0, 0.0), params


def composite(x, params):
    """Block.mlp_residual's ops in bf16: LayerNorm, fc1, GELU, fc2, then x + ls * y."""
    ln_w, ln_b, w1, b1, w2, b2, ls = params
    return x + ls * F.linear(F.gelu(F.linear(F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-6), w1, b1)), w2, b2)


def runner(lib, x, params, stream):
    """(call, stage_ms): one launch of the variant on fresh scratch, and the
    median over 5 calls of its three kernels' event times."""
    rows, f = x.shape
    hidden = params[2].shape[0]
    out = torch.empty_like(x)
    xn, g = torch.empty_like(x), torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    ptrs = [x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(), xn.data_ptr(), g.data_ptr()]

    def call(events=None):
        err = lib.run(*ptrs, rows, f, hidden, 1e-6, events, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    def stage_ms():
        times = []
        for _ in range(5):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            for e in events:  # a torch.cuda.Event makes its CUDA event at its first record
                e.record()
            handles = (ctypes.c_void_p * 4)(*(e.cuda_event for e in events))
            call(handles)
            events[-1].synchronize()
            times.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
        return [statistics.median(t[i] for t in times) for i in range(3)]

    return call, stage_ms


def check(label, got, want):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    top, mean_ref = float(want.float().abs().max()), float(want.float().abs().mean())
    ok = bool(torch.isfinite(got).all()) and float(err.max()) <= REL_MAX * top and float(err.mean()) <= REL_MEAN * mean_ref
    say(f"{label}: max abs err {float(err.max()):.3e} (max|ref| {top:.3e}), mean {float(err.mean()):.3e} "
        f"(mean|ref| {mean_ref:.3e})")
    if not ok and not any(f"[{name}]" in label for name in UNCHECKED):
        raise RuntimeError(f"{label} disagrees with the plain version")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="a directory for each build's whole nvcc output")
    parser.add_argument("names", nargs="*", help="variants to run (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mlp_sm90_variants.py runs on a CUDA card")
    names = args.names or list(VARIANTS)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = vb.card()
    libs = build(names, args.out)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for rows, f, hidden in SHAPES:
        x, params = inputs(rng, rows, f, hidden)
        want = fm.fused_ln_mlp_residual_reference(x, *params)
        runners = {name: runner(lib, x, params, stream) for name, lib in libs.items()}
        for name, (call, _) in runners.items():
            check(f"({rows}, {f}) H={hidden} [{name}]", call(), want)
        if (rows, f, hidden) == SHAPES[-1]:
            continue
        calls = {"composite": lambda: composite(x, params), **{name: call for name, (call, _) in runners.items()}}
        first = {label: ft.device_ms(fn) for label, fn in calls.items()}
        second = {label: ft.device_ms(fn) for label, fn in reversed(calls.items())}
        say(f"#8 bf16 ({rows}, {f}) H={hidden}: device ms per call (20 queued behind a spin, after 3; two turns, the "
            f"faster kept); LayerNorm / fc1 / fc2 kernels from events in one call (median of 5) [{smi}]")
        for label in calls:
            stages = "" if label == "composite" else " | " + " / ".join(f"{t:.4f}" for t in runners[label][1]())
            say(f"  {label:24s} {min(first[label], second[label]):9.4f} ms{stages}")
        del x, params, want, runners, calls
        torch.cuda.empty_cache()
    if args.out:
        with open(os.path.join(args.out, "mlp_sm90_variants.txt"), "w") as f:
            f.write("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
