#!/usr/bin/env python3
"""Design variants of the sm_90 window attention kernel
(``csrc/window_attention_sm90.cu``), timed on the card.

    python3 muggled_dpt_tpu_torch/tools/window_sm90_variants.py

Each variant is the source as committed with one design decision changed by
a text edit, built by nvcc into a library of its own (under the gitignored
``build/variants/``) with a C entry over raw pointers, and timed with CUDA
events in two turns (forward, then backward, the faster median kept) beside
one SDPA call on the summed bias, at SwinV2-L-384's four stage shapes at
B=8 and stage 1 at B=1 (bf16, q and k l2-normalized, q times a logit scale
of 10, v a view of one qkv tensor, a random CPB of 16 sigmoid(N(0, 1)) and
the 0 / -100 shift mask of stages 1 and 2), on random inputs from a seed.
Variants:
  * ``kernel``: as committed;
  * ``cluster 2``: thread-block clusters of 2 CTAs along the batch, each
    loading half the rows of every bias tile and multicasting them to both,
    so a bias tile crosses from L2 once per cluster; a bias stage is refilled
    once the consumers of both CTAs have released it (B=1 forms no cluster:
    not launched);
  * ``128 keys``: K, V and bias tiles of 128 keys, 2 stages (the masked
    instantiation does not fit in shared memory: not timed);
  * ``2 consumers``: 128 q rows per CTA, 240 registers per consumer thread;
  * ``6 stages``: a deeper ring (the unmasked instantiation only fits);
  * ``loads only`` (ablation): the consumers wait for each tile and release
    it, and compute nothing: the producer's TMA traffic alone, whose bytes
    over the time give this card's L2-to-SM rate for it;
  * ``no softmax`` (ablation): both products, no bias read and no exp2;
  * ``compute only`` (ablation): the producer fills the ring once and
    stops, the consumers run every key tile on what it holds: the work
    without the loads; ``compute, no bias reads`` and ``compute, no exp2``
    also leave out the bias tiles' ldmatrix or the exp2 of every logit;
  * ``L2 256B``: the tensor maps' L2 promotion at 256 bytes, not 128.
Each variant that computes the function is compared with the plain version;
the ablations' outputs are not. Runs only on a CUDA card; every line carries
the card's name and power limit."""

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

from muggled_dpt_tpu_torch.models.swinv2 import shift_mask  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels.window_attention import window_attention_reference  # noqa: E402

D = 32
CASES = (  # (label, B, windows per image, window side, heads, shift mask)
    ("stage 1", 8, 16, 24, 6, True),
    ("stage 2", 8, 4, 24, 12, True),
    ("stage 3", 8, 1, 24, 24, False),
    ("stage 4", 8, 1, 12, 48, False),
    ("stage 1", 1, 16, 24, 6, True),
)
ENTRY = r"""
extern "C" int run(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                   const long long* v_st, void* o, const long long* o_st, const void* cpb, const long long* c_st,
                   const void* mask, const long long* m_st, int batch, int nw, int n, int heads, void* stream) {
    return (int)window_attention_sm90(q, q_st, k, k_st, v, v_st, o, o_st, cpb, c_st, mask, m_st, batch, nw, n, heads,
                                      (cudaStream_t)stream);
}
"""
CONSUME = "        consume<MASK>(sm, &to, threadIdx.x / 128 - 1, b, q0, w, h, n, tiles);"
KERNEL = "template <bool MASK>\n__global__"
DRAIN = r"""template <bool MASK>
__device__ __forceinline__ void drain(Smem<MASK>& sm, int tiles) {
    const int lane = threadIdx.x % 32;
    mbar_wait(&sm.full_q, 0);
    for (int t = 0; t < tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t parity = (t / STAGES) & 1;
        mbar_wait(&sm.full_k[st], parity);
        release(&sm.empty_k[st], lane);
        mbar_wait(&sm.full_b[st], parity);
        release(&sm.empty_b[st], lane);
        mbar_wait(&sm.full_v[st], parity);
        release(&sm.empty_v[st], lane);
    }
}

"""
SOFTMAX_CALLS = ("    softmax_tile<MASK>(s, m, l, alpha, cpb_lane, mask_lane, 0, n, c);",
                 "        softmax_tile<MASK>(s, m, l, alpha, cpb_lane + st * BIAS_BYTES, mask_lane + st * BIAS_BYTES, t * BKV, n, c);")
PV_MARK = "// d (64 rows x 32, f32) += A (64 x 16 keys"
WGMMA_N128 = r"""__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

"""
# compute only: the producer fills the first STAGES tiles and stops; the consumers run every tile on them
COMPUTE_ONLY = [("    for (int t = 0; t < tiles; ++t) {", "    for (int t = 0; t < (tiles < STAGES ? tiles : STAGES); ++t) {"),
                ("        const uint32_t parity = (t / STAGES) & 1;", "        const uint32_t parity = 0;"),
                ("        mbar_wait(&sm.full_v[pst], ((t - 1) / STAGES) & 1);", "        mbar_wait(&sm.full_v[pst], 0);"),
                ("    mbar_wait(&sm.full_v[pst], ((tiles - 1) / STAGES) & 1);", "    mbar_wait(&sm.full_v[pst], 0);")]
NO_BIAS_READS = [("        ldsm_x4(cb, (cpb_addr ^ ((i % 8) << 4)) + step);", "        cb[0] = cb[1] = cb[2] = cb[3] = 0x3f803f80u;"),
                 ("        if constexpr (MASK) ldsm_x4(mb, (mask_addr ^ ((i % 8) << 4)) + step);", "        mb[0] = mb[1] = mb[2] = mb[3] = 0;")]
# cluster 2: the bias tiles multicast to a cluster of two CTAs of consecutive batch elements
CLUSTER_HELPERS = r"""constexpr int CLUSTER = 2;  // CTAs of consecutive batch elements sharing bias tiles by multicast

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Arrive on the barrier at `bar`'s offset in every CTA of the cluster.
__device__ __forceinline__ void release_cluster(uint64_t* bar, int lane) {
    if (lane != 0) return;
#pragma unroll
    for (uint32_t cta = 0; cta < CLUSTER; ++cta)
        asm volatile(
            "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
            "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)), "r"(cta)
            : "memory");
}

// One box of a 3-D tensor map into every CTA of the cluster at the same offset, each completion counted on the
// barrier at `bar`'s offset in that CTA.
__device__ __forceinline__ void tma_load3_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1, {%3, %4, "
        "%5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "h"((uint16_t)((1u << CLUSTER) - 1))
        : "memory");
}

"""
CLUSTER_LAUNCH = """    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES<MASK>;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, wa_sm90_bf16<MASK>, m.q, m.k, m.v, m.o, m.cpb, m.mask, n, heads);
    return err != cudaSuccess ? err : cudaGetLastError();
"""
STORE_MARK = "// Shared memory to the box of a 5-D tensor map"
CLUSTER_PATCH = [
    (STORE_MARK, CLUSTER_HELPERS + STORE_MARK),
    ("release(&sm.empty_b[", "release_cluster(&sm.empty_b["),
    ("""            const int offset = box * BQ * 64, key = t * BKV + 64 * box;
            tma_load3(sm.cpb[st] + offset, tc, &sm.full_b[st], key, q0, h);
            if constexpr (MASK) tma_load3(sm.mask.tile[st] + offset, tm, &sm.full_b[st], key, q0, w);""",
     """            const int slice = BQ / CLUSTER, rank = static_cast<int>(cluster_rank());  // this CTA's rows of the tile
            const int offset = box * BQ * 64 + rank * slice * 64, key = t * BKV + 64 * box, row = q0 + rank * slice;
            tma_load3_multicast(sm.cpb[st] + offset, tc, &sm.full_b[st], key, row, h);
            if constexpr (MASK) tma_load3_multicast(sm.mask.tile[st] + offset, tm, &sm.full_b[st], key, row, w);"""),
    ("mbar_init(&sm.empty_b[st], CONSUMER_WARPS);", "mbar_init(&sm.empty_b[st], CONSUMER_WARPS * CLUSTER);"),
    ("    __syncthreads();\n\n    if (threadIdx.x < 128) {",
     "    cluster_sync();  // every barrier of the cluster initialized before any multicast or remote arrival\n\n"
     "    if (threadIdx.x < 128) {"),
    (CONSUME + "\n    }\n}", CONSUME + "\n    }\n    __syncwarp();\n    cluster_sync();  // no CTA leaves while another may still arrive on its barriers\n}"),
    ("""    wa_sm90_bf16<MASK><<<grid, THREADS, SMEM_BYTES<MASK>, stream>>>(m.q, m.k, m.v, m.o, m.cpb, m.mask, n, heads);
    return cudaGetLastError();
""", CLUSTER_LAUNCH),
    ("encode_bias(fn, &m.cpb, cpb, c_st, n, heads, BQ);", "encode_bias(fn, &m.cpb, cpb, c_st, n, heads, BQ / CLUSTER);"),
    ("encode_bias(fn, &m.mask, mask, m_st, n, nw, BQ);", "encode_bias(fn, &m.mask, mask, m_st, n, nw, BQ / CLUSTER);"),
]
NO_EXP2 = [("        s[i] = ex2(fmaf(s[i], LOG2E, -m[(i >> 1) & 1]));  // a masked -inf gives 0",
            "        s[i] = fmaf(s[i], LOG2E, -m[(i >> 1) & 1]);")]


def variants() -> dict:
    """name: (text replacements, computes the function)."""
    return {
        "kernel": ([], True),
        "cluster 2": (CLUSTER_PATCH, True),
        "128 keys": ([("constexpr int BKV = 64;", "constexpr int BKV = 128;"), ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),
                      (PV_MARK, WGMMA_N128 + PV_MARK)], True),
        "2 consumers": ([("constexpr int CONSUMERS = 3;", "constexpr int CONSUMERS = 2;"),
                         ("PRODUCER_REGS = 32, CONSUMER_REGS = 160;", "PRODUCER_REGS = 24, CONSUMER_REGS = 240;")], True),
        "6 stages": ([("constexpr int STAGES = 3;", "constexpr int STAGES = 6;")], True),
        "loads only": ([(CONSUME, "        drain<MASK>(sm, tiles);"), (KERNEL, DRAIN + KERNEL)], False),
        "no softmax": ([(call, call[: len(call) - len(call.lstrip())] + "alpha[0] = alpha[1] = 1.f;") for call in SOFTMAX_CALLS], False),
        "compute only": (COMPUTE_ONLY, False),
        "compute, no bias reads": (COMPUTE_ONLY + NO_BIAS_READS, False),
        "compute, no exp2": (COMPUTE_ONLY + NO_EXP2, False),
        "L2 256B": ([("CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")], True),
    }


def variant_source(source: str, replacements) -> str:
    for old, new in replacements:
        if old not in source:
            raise RuntimeError(f"the source no longer holds {old!r}")
        source = source.replace(old, new)
    return source + ENTRY


def build() -> dict:
    """Every variant compiled at once, one nvcc each; returns {name: (library, computes the function)}."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (CSRC_DIR / "window_attention_sm90.cu").read_text()
    jobs = {}
    for i, (name, (replacements, exact)) in enumerate(variants().items()):
        src, lib = out_dir / f"window{i}.cu", out_dir / f"window{i}.so"
        src.write_text(variant_source(source, replacements))
        cmd = [find_nvcc(), "-Xptxas=-v", *NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        jobs[name] = (lib, exact, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, exact, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        used = [line.split(":", 1)[-1].strip() for line in log.splitlines() if "Used" in line or "spill" in line or "C75" in line]
        print(f"variant {name!r}: {'; '.join(used)}", flush=True)
        libs[name] = (ctypes.CDLL(str(lib)), exact)
        libs[name][0].run.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name][0].run.restype = ctypes.c_int
    return libs


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
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


def inputs(gen, b, nw, side, h, with_mask):
    """q, k, v (B, nW, A, H, D) views of one qkv, cpb (H, A, A), mask (nW, A, A) or None, all bf16."""
    a = side * side
    qkv = torch.randn(b, nw, a, 3, h, D, device="cuda", generator=gen)
    qkv[:, :, :, :2] *= torch.rsqrt((qkv[:, :, :, :2] ** 2).sum(-1, keepdim=True) + 1e-12)
    qkv[:, :, :, 0] *= 10.0
    q, k, v = qkv.to(torch.bfloat16).unbind(3)
    cpb = (16.0 * torch.sigmoid(torch.randn(h, a, a, device="cuda", generator=gen))).to(torch.bfloat16)
    mask = None
    if with_mask:
        grid = int(nw**0.5) * side
        mask = shift_mask((grid, grid), (side, side), (side // 2, side // 2), "cuda", torch.bfloat16)
    return q, k, v, cpb, mask


def sdpa_inputs(q, k, v, cpb, mask):
    """The window attention as one SDPA call takes it: (B nW, H, A, D) copies
    of q, k and v and the (B nW, H, A, A) sum of cpb and mask."""
    b, nw, a, h, d = q.shape
    q4, k4, v4 = (t.permute(0, 1, 3, 2, 4).reshape(b * nw, h, a, d) for t in (q, k, v))
    bias = cpb[None].expand(nw, h, a, a) if mask is None else cpb[None] + mask[:, None]
    return q4, k4, v4, bias[None].expand(b, nw, h, a, a).reshape(b * nw, h, a, a)


def strides(t) -> ctypes.Array:
    return (ctypes.c_longlong * len(t.stride()))(*t.stride())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("window_sm90_variants.py runs on a CUDA card")
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    smi = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, nw, side, h, with_mask in CASES:
        a = side * side
        q, k, v, cpb, mask = inputs(gen, b, nw, side, h, with_mask)
        out = torch.empty(b, nw, a, h, D, device="cuda", dtype=torch.bfloat16)
        ref = window_attention_reference(q, k, v, cpb, mask).float()
        qs, ks, vs, os_, cs = (strides(t) for t in (q, k, v, out, cpb))
        ms = strides(mask) if mask is not None else (ctypes.c_longlong * 3)(0, 0, 0)
        mp = mask.data_ptr() if mask is not None else None
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for name, (lib, exact) in libs.items():
            call = (lambda lib=lib: lib.run(q.data_ptr(), qs, k.data_ptr(), ks, v.data_ptr(), vs, out.data_ptr(), os_,
                                            cpb.data_ptr(), cs, mp, ms, b, nw, a, h, stream))
            err = call()
            torch.cuda.synchronize()
            if err != 0:
                print(f"  {name} {label} B={b}: not launched (CUDA error {err})", flush=True)
                continue
            if exact:
                diff = float((out.float() - ref).abs().max())
                print(f"  {name} {label} B={b}: max abs difference from the plain version {diff:.3e}", flush=True)
                if not diff <= 2e-2:
                    raise RuntimeError(f"variant {name!r} disagrees with the plain version at {label} B={b}")
            calls[name] = call
        readings = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                readings[name].append(time_ms(calls[name]))
        q4, k4, v4, m4 = sdpa_inputs(q, k, v, cpb, mask)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=1.0))
        pairs = b * nw * h * a * a
        bias_bytes = b * nw * h * ((a + 191) // 192) * 192 * a * 2 * (2 if with_mask else 1)  # what the CTAs read of the tables
        kv_bytes = b * nw * h * ((a + 191) // 192) * (2 * ((a + 63) // 64) * 64 + 192) * D * 2  # K, V and Q tiles
        base = min(readings["kernel"])
        print(f"#3 {label} B={b} nW={nw} A={a} H={h}{' mask' if with_mask else ''} bf16 (median of 30 after 5, two turns) "
              f"[{smi}]", flush=True)
        for name, ms_ in ((name, min(r)) for name, r in readings.items()):
            rate = (bias_bytes + kv_bytes) / ms_ / 1e9
            print(f"  {name:14s} {ms_:8.4f} ms  {ms_ / base:5.2f}x kernel  {pairs / ms_ / 1e9:6.2f} T pairs/s  "
                  f"{rate:6.2f} TB/s L2-to-SM loads", flush=True)
        print(f"  {'SDPA':14s} {sdpa:8.4f} ms  {sdpa / base:5.2f}x kernel", flush=True)
        del q, k, v, cpb, mask, out, ref, q4, k4, v4, m4
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
