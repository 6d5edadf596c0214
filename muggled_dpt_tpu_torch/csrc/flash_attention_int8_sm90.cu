// Flash attention with an int8 QK^T for Hopper (sm_90a): the quantize
// prologue of both entries, and the attention kernel of their bfloat16
// launches on int8 wgmma and TMA. mdpt_flash_attention_int8
// (csrc/flash_attention_int8.cu) runs the prologue for every launch, then
// this attention kernel for bfloat16 v and its own fa_int8_f32 for float32.
//
// Replaces two TPU kernels of experiments/flash_attention_int8.py together
// with their XLA prologues (which the JAX package runs outside the kernels):
//   #6 flash_attention_int8_qk       (:91)  -> _online_kernel_i8 (:44), (BH, N, D)
//   #7 flash_attention_int8_qk_fused (:223) -> _onepass_i8qk_kernel (:175), off
//      the head-major (B, N, 3C) qkv slab
//
// The prologue (two launches, one CTA per (chunk of 64 rows, head, batch)):
//   pass A  qf = float(q) * q_mul (#7: q_mul = scale log2(e); #6: 1);
//           per (b, n, h): sq = max(max |qf|, 1e-12) / 127, q_i8 = rint(qf / sq),
//           sq kept in alpha; the chunk's max |k| per (b, h) into kmax;
//   pass B  sk = max(max over the chunks of kmax, 1e-12) / 127,
//           k_i8 = rint(k / sk); alpha = sq sk (#7) or ((sq sk) scale) log2(e) (#6).
// Every step is one IEEE float32 operation in the order of the plain
// version (ops/kernels/flash_attention_int8.py: quantize_fused,
// quantize_rows), so the int8 q and k and alpha equal it bit for bit.
// Partial maxima combined by max are exact in any order, so the reduction
// over all rows needs no atomics and no zeroed buffer; one launch (a CTA
// per head and batch over every row) measured 2.1x slower at B=8 and 6x
// at B=1 (tools/int8_sm90_variants.py). Bound by bytes: at
// DA-V2 ViT-L's B=8 slab it reads q and k (42.5 MB of bf16) and k again
// (21.2 MB) and writes 21.2 MB of int8 and 0.7 MB of alpha: 0.025 ms at
// 3.35 TB/s. The design keeps every access a 16-byte load or an 8-byte
// store, eight lanes to a 64-wide row, and 2688 CTAs of 256 threads at that
// slab (about 20 per SM) for enough loads in flight.
//
// The attention kernel computes, per batch b and head h,
//   s[i, j] = float(int32(q_i8[b, i, h, :] . k_i8[b, j, h, :])) * alpha[b, h, i]
//   out[b, i, h, :] = sum_j p[i, j] v[b, j, h, :] / sum_j p[i, j],  p = bf16(exp2(s - m_i))
// with the plain version's rounding points (int8_attention_reference): the
// exact integer logits (|q . k| <= 127^2 * 64 < 2^24) times alpha in one
// float32 rounding; the running max m of s; p rounded to bf16, and the row
// sum l adding the rounded p (the TPU kernels' ones column of v_ext); O +=
// P V in bf16 on the tensor cores with f32 sums; out = O / max(l, 1e-30).
// Keys at or past N get s = NEG_INF (-1e30) by index, never a pad-count
// correction; q rows past N are computed on zeros and never written.
//
// Bound on an H100 SXM at DA-V2 ViT-L's slab (B=8, N=1297, 16 heads): QK^T
// is 27.6 G int8 operations (0.014 ms at 1979 TOP/s), PV 27.6 GFLOP in bf16
// (0.028 ms at 989 TFLOP/s), and each (q, k) pair takes one exp2 on the SFU
// (16 per clock per SM: 0.056 ms). So, as for #1, the softmax bounds the
// kernel, not the products, and the int8 products save tensor-core time the
// kernel does not wait on: per logit the consumers issue the conversion, the
// scale, the max, the subtraction, the exp2, half a pack and the rounded row
// sum, and the issue slots, not one pipe, set the pace (measured on an H100
// by the ablations of tools/int8_sm90_variants.py: PERF.md).
//
// Design (#1's pipeline, csrc/flash_attention_sm90.cu; one CTA per 192 q
// rows, head and batch; 4 warpgroups):
//   * producer warpgroup (setmaxnreg.dec): one thread issues TMA: the int8
//     Q tile (192 rows x 64 B) once, then int8 K tiles (128 keys x 64 B) and
//     bf16 V tiles (128 keys x 128 B) into a ring of STAGES stages, each with
//     a full and an empty mbarrier. The int8 maps are 4-D (D, H, N, B) over
//     the prologue's (B, N, H, D) scratch with the 64-byte swizzle (a 64-byte
//     row is one swizzle span); V's map is #1's: the caller's strides (#7's v
//     in place in the slab), the 128-byte swizzle. Rows past N arrive as zeros.
//   * three consumer warpgroups of 64 q rows (setmaxnreg.inc 160): S = Q K^T
//     by wgmma m64n128k32 s8 x s8 -> s32, two k steps over D = 64 bytes,
//     both operands K-major in shared memory (8-bit wgmma takes no other
//     layout); the s32 accumulator has the f32 one's fragment layout. The
//     integer becomes a float by I2F, one instruction: the two-instruction
//     bias trick on the FP32 pipe (1.5 * 2^23 added to the bits) measured
//     9 % slower. P is packed to bf16 in registers (wgmma's A fragment), and its
//     rounded values summed into l, once the PV before has retired, as #1
//     packs; O += P V by wgmma m64n64k16 with V MN-major through the
//     descriptor, as #1. (Packing inside the softmax, under the PV, made
//     ptxas serialize the wgmma, C7511, and spill.)
//   * overlap as #1: tile t's QK^T and tile t-1's PV issued together, tile
//     t's softmax under the PV; the ragged last tile runs the full 128 keys
//     with the keys past N masked (a wgmma under a runtime condition would
//     serialize every wgmma of the kernel, ptxas C7520).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90_attention.cuh"

namespace {

// ---------------------------------------------------------------- prologue

constexpr int PRO_THREADS = 256;                 // 32 groups of 8 lanes, one 64-wide row per group
constexpr int PRO_GROUPS = PRO_THREADS / 8;
constexpr int PRO_ROWS = 64;                     // rows per chunk: one CTA per (chunk, head, batch)
constexpr int ALPHA_SQSK = 0, ALPHA_SCALED = 1;  // alpha = sq sk (#7), or ((sq sk) scale) log2(e) (#6)

struct Prologue {
    const void* q;
    const void* k;
    long long q_sb, q_sn, q_sh;  // element strides: batch, row, head (D contiguous)
    long long k_sb, k_sn, k_sh;
    int8_t* q_i8;                // (B, N, H, D)
    int8_t* k_i8;                // (B, N, H, D)
    float* alpha;                // (B, H, N): sq after pass A, alpha after pass B
    float* kmax;                 // (B, H, chunks): max |k| of each chunk's rows
    int n, heads, chunks, mode;
    float q_mul, scale;
};

// This lane's 8 values of a 64-wide row, as float32 (exact for bf16).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// rint(x / s) for 8 values, packed as 8 int8 bytes (|x / s| <= 127 by construction)
__device__ __forceinline__ uint2 quantize8(const float (&x)[8], float s) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i / 4] |= (static_cast<uint32_t>(__float2int_rn(__fdiv_rn(x[i], s))) & 0xffu) << (8 * (i % 4));
    return make_uint2(w[0], w[1]);
}

// max over the 8 lanes of a group (lanes 8j .. 8j + 7 of a warp)
__device__ __forceinline__ float group_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

// Pass A over the chunk's rows of head h, batch b: q quantized, sq into
// alpha; returns this lane's max |k|. Every lane runs the shuffles; rows past
// N read row 0 and write nothing.
template <typename T>
__device__ __forceinline__ float quantize_q_chunk(const Prologue& p, int chunk, int h, int b) {
    const int group = threadIdx.x / 8, lane8 = threadIdx.x % 8;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + 8 * lane8;
    const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + 8 * lane8;
    float kmx = 0.f;
#pragma unroll 2
    for (int r = group; r < PRO_ROWS; r += PRO_GROUPS) {
        const int row = chunk * PRO_ROWS + r;
        const bool valid = row < p.n;
        float x[8], kx[8];
        load8(qb + (valid ? row : 0) * p.q_sn, x);
        load8(kb + (valid ? row : 0) * p.k_sn, kx);
        float mx = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            x[i] = __fmul_rn(x[i], p.q_mul);
            mx = fmaxf(mx, fabsf(x[i]));
            if (valid) kmx = fmaxf(kmx, fabsf(kx[i]));
        }
        const float sq = __fdiv_rn(fmaxf(group_max(mx), 1e-12f), 127.0f);
        if (valid) {
            const long long unit = (static_cast<long long>(b) * p.n + row) * p.heads + h;  // (b, row, h) of the scratch
            reinterpret_cast<uint2*>(p.q_i8 + unit * D)[lane8] = quantize8(x, sq);
            if (lane8 == 0) p.alpha[(static_cast<long long>(b) * p.heads + h) * p.n + row] = sq;
        }
    }
    return kmx;
}

// Pass B over the chunk's rows: k quantized by sk, alpha from sq.
template <typename T>
__device__ __forceinline__ void quantize_k_chunk(const Prologue& p, int chunk, int h, int b, float sk) {
    const int group = threadIdx.x / 8, lane8 = threadIdx.x % 8;
    const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + 8 * lane8;
    float* ab = p.alpha + (static_cast<long long>(b) * p.heads + h) * p.n;
#pragma unroll 2
    for (int r = group; r < PRO_ROWS; r += PRO_GROUPS) {
        const int row = chunk * PRO_ROWS + r;
        if (row >= p.n) break;
        float kx[8];
        load8(kb + row * p.k_sn, kx);
        const long long unit = (static_cast<long long>(b) * p.n + row) * p.heads + h;
        reinterpret_cast<uint2*>(p.k_i8 + unit * D)[lane8] = quantize8(kx, sk);
        if (lane8 == 0) {
            const float a = __fmul_rn(ab[row], sk);
            ab[row] = p.mode == ALPHA_SQSK ? a : __fmul_rn(__fmul_rn(a, p.scale), LOG2E);
        }
    }
}

// The CTA's max of each thread's v (v >= 0), in every thread
__device__ __forceinline__ float cta_max(float v) {
    __shared__ float part[PRO_THREADS / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();  // part may still be read by an earlier call
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
    __syncthreads();
    v = part[0];
#pragma unroll
    for (int w = 1; w < PRO_THREADS / 32; ++w) v = fmaxf(v, part[w]);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(PRO_THREADS) i8_pass_a(const Prologue p) {
    const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const float kmx = cta_max(quantize_q_chunk<T>(p, chunk, h, b));
    if (threadIdx.x == 0) p.kmax[(static_cast<long long>(b) * p.heads + h) * p.chunks + chunk] = kmx;
}

template <typename T>
__global__ void __launch_bounds__(PRO_THREADS) i8_pass_b(const Prologue p) {
    const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const float* km = p.kmax + (static_cast<long long>(b) * p.heads + h) * p.chunks;
    float kmx = 0.f;
    for (int c = 0; c < p.chunks; ++c) kmx = fmaxf(kmx, km[c]);
    quantize_k_chunk<T>(p, chunk, h, b, __fdiv_rn(fmaxf(kmx, 1e-12f), 127.0f));
}

template <typename T>
cudaError_t launch_prologue(const Prologue& p, int batch, cudaStream_t stream) {
    const dim3 grid(p.chunks, p.heads, batch);
    i8_pass_a<T><<<grid, PRO_THREADS, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    i8_pass_b<T><<<grid, PRO_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

// --------------------------------------------------------------- attention

constexpr int CONSUMERS = 3;        // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;  // q rows per CTA
constexpr int BKV = 128;            // keys per K / V tile
constexpr int STAGES = 2;           // K / V ring depth
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup, then the consumers
// registers per thread after setmaxnreg: the producer gives up what the consumers take
constexpr int PRODUCER_REGS = CONSUMERS == 3 ? 32 : 40, CONSUMER_REGS = CONSUMERS == 3 ? 160 : 232;
constexpr int CTA_REGS = 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
static_assert(CTA_REGS <= 65536, "the register file holds one CTA");
constexpr uint32_t Q_BYTES = BQ * D, K_BYTES = BKV * D, V_BYTES = BKV * D * 2;  // int8 q and k tiles, a bf16 v tile
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;  // each arrives once on an empty barrier

struct Smem {  // at a 1024-byte aligned address: V's 128B swizzle repeats every 1024 bytes, Q's and K's 64B one every 512
    __nv_bfloat16 v[STAGES][BKV * D];
    int8_t q[BQ * D];
    int8_t k[STAGES][BKV * D];
    uint64_t full_q, full_k[STAGES], full_v[STAGES], empty_k[STAGES], empty_v[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // slack to align the base

struct Params {
    __nv_bfloat16* o;
    long long sb, sn, sh;         // out's element strides: batch, row, head
    const float* alpha;           // (B, H, N)
    long long a_sb, a_sh, a_sn;   // its element strides: batch, head, row
    int n;
};

// wgmma descriptor of a 64B-swizzled tile of 64-byte rows (int8 D = 64):
// start address >> 4, leading byte offset 1 (unused: a k step of 32 bytes
// stays inside one swizzle span), stride byte offset 512 B >> 4 (from one
// 8-row group to the next), swizzle mode 2 (64B); a k step moves the start
// address by 32 bytes.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define IACC8(i) \
    "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// d (64 rows x 128 keys, s32) = or += A (64 x 32 of D, int8) B^T (128 keys x 32 of D, int8), both K-major in shared memory
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : IACC8(0), IACC8(8), IACC8(16), IACC8(24), IACC8(32), IACC8(40), IACC8(48), IACC8(56)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef IACC8

// S = Q K^T over D = 64 int8: two k steps of 32 bytes
__device__ __forceinline__ void issue_qk_s8(uint32_t (&s)[64], uint64_t dq, const int8_t* k_tile) {
    const uint64_t dk = sw64_desc(k_tile);
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) wgmma_s8(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// The online softmax of one S tile in place, exp2 domain. In: s holds the
// exact int32 logits. Out: s holds the float32 p = exp2(s - m), m the new
// row max of the logits, corr the factor for the old accumulator, l the
// rescaled partial row sum. Keys at or past N (MASK: the last tile) get
// NEG_INF, so p = 0.
template <bool MASK>
__device__ __forceinline__ void softmax_i8(uint32_t (&s)[64], float (&m)[2], float (&l)[2], float (&corr)[2],
                                           const float (&al)[2], int kbase, int n, int c) {
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float f = __int2float_rn(static_cast<int>(s[4 * i + e]));  // exact: |s| < 2^24
            const float x = MASK && key_masked(kbase, i, e, c, n) ? NEG_INF : f * al[e >> 1];
            s[4 * i + e] = __float_as_uint(x);
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = __float_as_uint(ex2(__uint_as_float(s[i]) - m[(i >> 1) & 1]));
}

__device__ __forceinline__ void softmax_tile(uint32_t (&s)[64], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             const float (&al)[2], int kbase, int n, int c) {
    if (kbase + BKV <= n) {
        softmax_i8<false>(s, m, l, corr, al, kbase, n, c);
    } else {
        softmax_i8<true>(s, m, l, corr, al, kbase, n, c);
    }
}

// P in bf16 (pack_p's order: the S fragments of keys 16j..16j+15 are the A
// fragment of PV k step j, register i in row g + 8 (i & 1)), and l adding
// p as rounded: the row sum of the TPU kernels' ones column of v_ext.
__device__ __forceinline__ void take_p(uint32_t (&p)[8][4], const uint32_t (&s)[64], float (&l)[2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t pk = pack_bf16(__uint_as_float(s[8 * j + 2 * i]), __uint_as_float(s[8 * j + 2 * i + 1]));
            l[i & 1] += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xffff0000u);
            p[j][i] = pk;
        }
}

// Consumer warpgroup `wg`: q rows q0 + 64 wg .. + 63 over every key tile.
__device__ __forceinline__ void consume(Smem& sm, const Params& a, int wg, int q0, int b, int h, int tiles) {
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int n = a.n;
    const uint64_t dq = sw64_desc(sm.q + wg * 64 * D);
    const int row_g = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: row_g and row_g + 8
    float al[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        al[r] = row < n ? a.alpha[b * a.a_sb + h * a.a_sh + row * a.a_sn] : 0.f;
    }

    uint32_t s[64], p[8][4];
    float o[32], corr[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0u;  // overwritten by the first k step; keeps the operand defined
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    mbar_wait(&sm.full_q, 0);

    // key tile 0: S only
    mbar_wait(&sm.full_k[0], 0);
    wgmma_fence();
    issue_qk_s8(s, dq, sm.k[0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(&sm.empty_k[0], lane);
    softmax_tile(s, m, l, corr, al, 0, n, c);
    take_p(p, s, l);

    // key tile t: S_t and PV_{t-1} issued together, softmax_t under PV_{t-1}
    for (int t = 1; t < tiles; ++t) {
        const int st = t % STAGES, pst = (t - 1) % STAGES;
        mbar_wait(&sm.full_k[st], (t / STAGES) & 1);
        mbar_wait(&sm.full_v[pst], ((t - 1) / STAGES) & 1);
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_qk_s8(s, dq, sm.k[st]);
        wgmma_commit();
        issue_pv(o, p, sm.v[pst]);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        release(&sm.empty_k[st], lane);
        softmax_tile(s, m, l, corr, al, t * BKV, n, c);
        wgmma_wait<0>();
        fence_regs(o);
        release(&sm.empty_v[pst], lane);
        rescale(o, corr);
        take_p(p, s, l);
    }

    // the last PV
    const int pst = (tiles - 1) % STAGES;
    mbar_wait(&sm.full_v[pst], ((tiles - 1) / STAGES) & 1);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv(o, p, sm.v[pst]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* ob = a.o + b * a.sb + h * a.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        if (row < n) {
            const float lr = fmaxf(l[r], 1e-30f);
            __nv_bfloat16* op = ob + row * a.sn;
#pragma unroll
            for (int i = 0; i < 8; ++i)
                *reinterpret_cast<uint32_t*>(op + 8 * i + 2 * c) = pack_bf16(o[4 * i + 2 * r] / lr, o[4 * i + 2 * r + 1] / lr);
        }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    fa_i8_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params a) {
    extern __shared__ uint8_t smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
    const int b = blockIdx.x, q0 = blockIdx.y * BQ, h = blockIdx.z;  // batch fastest
    const int tiles = (a.n + BKV - 1) / BKV;

    if (threadIdx.x == 0) {
        mbar_init(&sm.full_q, 1);
#pragma unroll
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(&sm.full_k[st], 1);
            mbar_init(&sm.full_v[st], 1);
            mbar_init(&sm.empty_k[st], CONSUMER_WARPS);
            mbar_init(&sm.empty_v[st], CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every TMA copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            mbar_expect_tx(&sm.full_q, Q_BYTES);
            tma_load(sm.q, &tq, &sm.full_q, 0, h, q0, b);
            for (int t = 0; t < tiles; ++t) {
                const int st = t % STAGES;
                const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;  // the first pass finds every stage free
                mbar_wait(&sm.empty_k[st], free_parity);
                mbar_expect_tx(&sm.full_k[st], K_BYTES);
                tma_load(sm.k[st], &tk, &sm.full_k[st], 0, h, t * BKV, b);
                mbar_wait(&sm.empty_v[st], free_parity);
                mbar_expect_tx(&sm.full_v[st], V_BYTES);
                tma_load(sm.v[st], &tv, &sm.full_v[st], 0, h, t * BKV, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
        consume(sm, a, threadIdx.x / 128 - 1, q0, b, h, tiles);
    }
}

// The (D, H, N, B) int8 tensor map of the prologue's (B, N, H, D) scratch,
// 64B swizzle, zeros past the edges; boxes of `rows` rows of one head.
CUresult encode_i8(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch, int n, int heads, cuuint32_t rows) {
    const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(batch)};
    const cuuint64_t stride[3] = {D, static_cast<cuuint64_t>(heads) * D, static_cast<cuuint64_t>(n) * heads * D};
    const cuuint32_t box[4] = {D, 1, rows, 1}, unit[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims, stride, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

cudaError_t launch_attention(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p, int batch,
                             int heads, cudaStream_t stream) {
    // once per device: the dynamic shared memory limit, and a check that the
    // registers granted at launch cover what setmaxnreg hands out (a short
    // pool would leave the consumers waiting for registers forever)
    static std::atomic<unsigned long long> configured{0};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (bit == 0 || !(configured.load() & bit)) {
        cudaFuncAttributes at;
        err = cudaFuncGetAttributes(&at, fa_i8_sm90);
        if (err != cudaSuccess) return err;
        if (at.numRegs * THREADS < CTA_REGS) return cudaErrorInvalidConfiguration;
        err = cudaFuncSetAttribute(fa_i8_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return err;
        configured.fetch_or(bit);
    }
    const dim3 grid(batch, (p.n + BQ - 1) / BQ, heads);
    fa_i8_sm90<<<grid, THREADS, SMEM_BYTES, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace

// The prologue on the current device, for every launch of the C entry.
// q and k: addresses and (batch, row, head) element strides of float32
// (`bf16` 0) or bfloat16 (1) values, D = 64 contiguous and every row 16-byte
// aligned; q_i8 and k_i8: (B, N, H, D) int8; alpha: (B, H, N) float32; kmax:
// (B, H, ceil(N / 64)) float32 scratch. `mode` 0: alpha = sq sk, 1: alpha =
// ((sq sk) scale) log2(e). Returns the error of a launch.
cudaError_t int8_prologue(const void* q, const long long* q_st, const void* k, const long long* k_st, int bf16, void* q_i8,
                          void* k_i8, float* alpha, float* kmax, int batch, int n, int heads, int mode, float q_mul, float scale,
                          cudaStream_t stream) {
    if (mode != ALPHA_SQSK && mode != ALPHA_SCALED) return cudaErrorInvalidValue;
    const Prologue p{q,    k,          q_st[0], q_st[1], q_st[2], k_st[0], k_st[1], k_st[2], static_cast<int8_t*>(q_i8),
                     static_cast<int8_t*>(k_i8), alpha, kmax, n, heads, (n + PRO_ROWS - 1) / PRO_ROWS, mode, q_mul, scale};
    return bf16 ? launch_prologue<__nv_bfloat16>(p, batch, stream) : launch_prologue<float>(p, batch, stream);
}

// The attention kernel on the current device, on the prologue's q_i8, k_i8
// and alpha, with bf16 v (address and (batch, row, head) element strides,
// rows 16-byte aligned) and bf16 out (the same). Returns the error of a
// tensor-map encode (a CUresult, whose codes agree with cudaError_t's for
// invalid values) or of the launch.
cudaError_t flash_attention_int8_sm90(const void* q_i8, const void* k_i8, const float* alpha, const void* v,
                                      const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads,
                                      cudaStream_t stream) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    CUresult r = encode_i8(fn, &tq, q_i8, batch, n, heads, BQ);
    if (r == CUDA_SUCCESS) r = encode_i8(fn, &tk, k_i8, batch, n, heads, BKV);
    if (r == CUDA_SUCCESS) r = encode_qkv(fn, &tv, v, v_st, batch, n, heads, BKV);
    if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(r);
    const long long hn = static_cast<long long>(heads) * n;
    const Params p{static_cast<__nv_bfloat16*>(o), o_st[0], o_st[1], o_st[2], alpha, hn, n, 1, n};
    return launch_attention(tq, tk, tv, p, batch, heads, stream);
}

// The attention kernel's resources, for a report: out: registers per thread
// at launch (before setmaxnreg), local memory (spill) bytes per thread,
// static and dynamic shared memory bytes, threads per block, q rows per CTA,
// K/V stages, the consumers' registers after setmaxnreg. Returns the
// cudaError_t.
extern "C" int mdpt_flash_attention_int8_sm90_info(int* out) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, fa_i8_sm90);
    if (err != cudaSuccess) return (int)err;
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)at.sharedSizeBytes;
    out[3] = SMEM_BYTES;
    out[4] = at.maxThreadsPerBlock;
    out[5] = BQ;
    out[6] = STAGES;
    out[7] = CONSUMER_REGS;
    return 0;
}
