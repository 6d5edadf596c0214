// Unbiased bfloat16 flash attention for Hopper (sm_90a): wgmma, TMA and a
// warp-specialised producer. Every bfloat16 launch of mdpt_flash_attention
// (csrc/flash_attention.cu) without a bias runs here; the biased and the
// float32 launches stay in flash_attention.cu.
//
// Replaces two TPU kernels of muggled_dpt_tpu/ops/pallas/flash_attention.py,
// the same unbiased math on differently laid-out inputs:
//   #1 flash_attention_fused_qkv (:310), unbiased -> _onepass_qkv_kernel (:125)
//   #5 _flash_bhnd_prescaled online                -> _online_kernel (:497)
// and the unbiased launches of #4 (the (B, N, H, D) op at N <= 32768,
// _onepass_kernel :86). Per batch b and head h it computes
//   out[b, i, h, :] = sum_j softmax_j(q_i . k_j * scale) v_j,   D = 64,
// q, k and v read in place through (batch, row, head) strides: the fused
// qkv slab's 3C / 3D, or a (B, N, H, D) view's own.
//
// Bound on an H100 SXM: each (q, k) pair costs 4 D = 256 tensor-core FLOPs
// (QK^T and PV) and one exp2 on the SFU. At 989 TFLOP/s bf16 and 16 ex2 per
// clock per SM (132 SMs, 1.83 GHz) both rates are 3.86e12 pairs/s: at D = 64
// the exp is a co-bound of the products, so the kernel has to overlap the
// softmax with the GEMMs to get near either. The bytes (q, k, v read once,
// out written once) are far below both; what is not is the K/V traffic from
// L2, N^2 H B * 256 B / BQ, which a taller q tile divides.
//
// Design (one CTA per 192 q rows, head and batch; 4 warpgroups):
//   * producer warpgroup: gives up registers (setmaxnreg.dec 24); one thread
//     issues TMA: the 192 x 64 Q tile once, then K and V tiles of 128 keys
//     into a ring of STAGES stages, each with a full and an empty mbarrier
//     per operand. The tensor maps are 4-D (D, H, N, B) with the caller's
//     byte strides and 128-byte swizzle, encoded on the host per launch;
//     rows past N arrive as zeros.
//   * three consumer warpgroups of 64 q rows (setmaxnreg.inc 160):
//     S = Q K^T by wgmma m64n128k16, both operands from shared memory
//     through descriptors (K-major, 128B swizzle); the online softmax on
//     the f32 accumulator in registers (its layout repeats mma.sync's
//     m16n8 C fragment per warp: row max by two shuffles, the scale folded
//     into the exp2's FFMA); P packed to bf16 in place, which is wgmma's
//     register A fragment; O += P V by wgmma m64n64k16 with A from
//     registers and V from shared memory, transposed by the descriptor (V is
//     stored [key][d], MN-major).
//   * overlap: tile t's QK^T and tile t-1's PV are issued together; the
//     softmax of tile t runs while PV t-1 is in flight (a K stage is
//     released once its S is done, a V stage once its PV is). The consumers
//     take turns issuing their GEMMs (named barriers, "ping-pong" extended
//     to three), so one warpgroup's softmax overlaps the others' tensor-core
//     work, and each SM sub-partition holds three consumer warps.
//   Three consumers (192 q rows) rather than two (128): a third less K/V
//   traffic from L2 and one more warp per sub-partition to hide the exp2
//   and the waits; 160 registers still hold S, O and P without spills
//   (measured on an H100: 13-17 % faster than two consumers at DA-V2
//   ViT-L's shapes; PERF.md).
// Numerics kept from the TPU kernels and csrc/flash_attention.cu:
//   * exp2 domain: scale * log2(e) applied to the f32 logits (q is not
//     rounded a second time);
//   * keys at or past N are masked by index (TMA's zero rows would give
//     logit 0, not -inf): left out of the max and given p = 0, never a
//     pad-count correction;
//   * l summed from the f32 p; p rounded to bf16 before PV;
//     out = acc / max(l, 1e-30), rounded to bf16;
//   * q rows past N are computed on zeros and never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int D = 64;              // head dim: one 128-byte swizzle row of bf16
constexpr float NEG_INF = -1e30f;  // the JAX package's masking constant
constexpr int CONSUMERS = 3;       // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;  // q rows per CTA
constexpr int BKV = 128;           // keys per K / V tile
constexpr int STAGES = 2;          // K / V ring depth
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup, then the consumers
// registers per thread after setmaxnreg: the producer gives up what the consumers take
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;
static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <= 65536, "the register file holds one CTA");
constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;  // one bf16 tile of q, of k or of v
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;  // each arrives once on an empty barrier
constexpr int BAR_TURN = 1;  // named barrier BAR_TURN + w: consumer w's turn to issue its GEMMs

struct Smem {  // at a 1024-byte aligned address: the 128B swizzle repeats every 8 rows
    __nv_bfloat16 q[BQ * D];
    __nv_bfloat16 k[STAGES][BKV * D];
    __nv_bfloat16 v[STAGES][BKV * D];
    uint64_t full_q, full_k[STAGES], full_v[STAGES], empty_k[STAGES], empty_v[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // slack to align the base

struct Out {
    __nv_bfloat16* o;
    long long sb, sn, sh;  // element strides: batch, row, head
    int n;
    float qk_scale_log2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// One 4-D box (64, 1, rows, 1) at (0, h, row, b) into shared memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int h, int row, int b) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(row), "r"(b)
        : "memory");
}

__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// issue or wait: the accumulators change asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// wgmma descriptor of a 128B-swizzled tile of 128-byte rows: start address
// >> 4, leading byte offset 1 (unused by the swizzled layouts at these
// widths), stride byte offset 1024 B >> 4 (from one 8-row group to the
// next), swizzle mode 1 (128B). Both the K-major Q and K tiles and the
// MN-major V tile have this layout; a k step moves the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define ACC8(i) \
    "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 rows x 128 keys, f32) = or += A (64 x 16 of D) B^T (128 keys x 16 of D), both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
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

// d (64 rows x 64, f32) += A (64 x 16 keys, bf16 registers) B (16 keys x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef ACC8

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T over D = 64: four k steps of 16 (32 bytes along the swizzled rows)
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, const __nv_bfloat16* k_tile) {
    const uint64_t dk = sw128_desc(k_tile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// O += P V over 128 keys: eight k steps of 16 keys (16 rows of 128 B = 2048 B)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[8][4], const __nv_bfloat16* v_tile) {
    const uint64_t dv = sw128_desc(v_tile);
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) wgmma_pv(o, p[j], dv + j * (16 * 128 >> 4));
}

// This thread holds rows g and g + 8 of its warp's 16 in an S tile:
// s[4i + e] is row g + 8 (e >> 1), key kbase + 8i + 2c + (e & 1).
__device__ __forceinline__ bool key_masked(int kbase, int i, int e, int c, int n) { return kbase + 8 * i + 2 * c + (e & 1) >= n; }

// The raw row max of s (of -s for a negative scale), keys at or past N left out.
template <bool MASK, bool NEG>
__device__ __forceinline__ void row_max(const float (&s)[64], float (&mx)[2], int kbase, int n, int c) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x = NEG ? -s[4 * i + e] : s[4 * i + e];
            mx[e >> 1] = fmaxf(mx[e >> 1], MASK && key_masked(kbase, i, e, c, n) ? -INFINITY : x);
        }
    }
}

// The online softmax of one S tile in place, exp2 domain: the logit of s is
// s * scale_log2, folded with the row max into one FFMA per element. Keys at
// or past N (MASK: the last tile) count in neither the max nor the sum. On
// return s holds the f32 p, m the new row max of the logits, alpha the
// factor for the old accumulator, l the rescaled partial row sum.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                               int kbase, int n, int c) {
    float mx[2] = {-INFINITY, -INFINITY};
    if (scale_log2 >= 0.f) {
        row_max<MASK, false>(s, mx, kbase, n, c);
    } else {
        row_max<MASK, true>(s, mx, kbase, n, c);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * fabsf(scale_log2));  // the max of the logits
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[4 * i + e], scale_log2, -m[e >> 1]));
            s[4 * i + e] = MASK && key_masked(kbase, i, e, c, n) ? 0.f : p;
            l[e >> 1] += s[4 * i + e];
        }
    }
}

__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                             int kbase, int n, int c) {
    if (kbase + BKV > n) {
        online_softmax<true>(s, m, l, alpha, scale_log2, kbase, n, c);
    } else {
        online_softmax<false>(s, m, l, alpha, scale_log2, kbase, n, c);
    }
}

// P in bf16: the S fragments of keys 16j..16j+15 are the A fragment of PV k step j
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[j][i] = pack_bf16(s[8 * j + 2 * i], s[8 * j + 2 * i + 1]);
    }
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
    }
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
    if (lane == 0) mbar_arrive(bar);
}

// Consumer warpgroup `wg`: q rows q0 + 64 wg .. + 63 over every key tile.
// The consumers issue their GEMMs in turn, 0, 1, 2, 0, 1, 2, ...: each waits
// for its turn (named barrier `mine`) and passes it on once its GEMMs are
// issued (`next`), so one's softmax runs under the others' tensor-core work.
__device__ __forceinline__ void consume(Smem& sm, const Out& a, int wg, int q0, int b, int h, int tiles) {
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int n = a.n;
    const int mine = BAR_TURN + wg, next = BAR_TURN + (wg + 1) % CONSUMERS;
    const bool last = wg == CONSUMERS - 1;
    const uint64_t dq = sw128_desc(sm.q + wg * 64 * D);

    float s[64], o[32], alpha[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;  // overwritten by the first k step; keeps the operand defined
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    if (last) bar_arrive(BAR_TURN);  // consumer 0 issues first
    mbar_wait(&sm.full_q, 0);

    // key tile 0: S only
    mbar_wait(&sm.full_k[0], 0);
    bar_sync(mine);
    wgmma_fence();
    issue_qk(s, dq, sm.k[0]);
    wgmma_commit();
    bar_arrive(next);
    wgmma_wait<0>();
    fence_regs(s);
    release(&sm.empty_k[0], lane);
    softmax_tile(s, m, l, alpha, a.qk_scale_log2, 0, n, c);
    pack_p(p, s);

    // key tile t: S_t and PV_{t-1} issued together, softmax_t under PV_{t-1}
    for (int t = 1; t < tiles; ++t) {
        const int st = t % STAGES, pst = (t - 1) % STAGES;
        mbar_wait(&sm.full_k[st], (t / STAGES) & 1);
        mbar_wait(&sm.full_v[pst], ((t - 1) / STAGES) & 1);
        fence_regs(o);
        fence_regs(p);
        bar_sync(mine);
        wgmma_fence();
        issue_qk(s, dq, sm.k[st]);
        wgmma_commit();
        issue_pv(o, p, sm.v[pst]);
        wgmma_commit();
        bar_arrive(next);
        wgmma_wait<1>();
        fence_regs(s);
        release(&sm.empty_k[st], lane);
        softmax_tile(s, m, l, alpha, a.qk_scale_log2, t * BKV, n, c);
        wgmma_wait<0>();
        fence_regs(o);
        release(&sm.empty_v[pst], lane);
        rescale(o, alpha);
        pack_p(p, s);
    }

    // the last PV
    const int pst = (tiles - 1) % STAGES;
    mbar_wait(&sm.full_v[pst], ((tiles - 1) / STAGES) & 1);
    fence_regs(o);
    fence_regs(p);
    bar_sync(mine);
    wgmma_fence();
    issue_pv(o, p, sm.v[pst]);
    wgmma_commit();
    if (!last) bar_arrive(next);  // the last consumer's last turn has no successor
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row_g = q0 + wg * 64 + warp * 16 + g;
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
    fa_sm90_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Out a) {
    extern __shared__ uint8_t smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
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

    if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            mbar_expect_tx(&sm.full_q, Q_BYTES);
            tma_load(sm.q, &tq, &sm.full_q, h, q0, b);
            for (int t = 0; t < tiles; ++t) {
                const int st = t % STAGES;
                const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;  // the first pass finds every stage free
                mbar_wait(&sm.empty_k[st], free_parity);
                mbar_expect_tx(&sm.full_k[st], KV_BYTES);
                tma_load(sm.k[st], &tk, &sm.full_k[st], h, t * BKV, b);
                mbar_wait(&sm.empty_v[st], free_parity);
                mbar_expect_tx(&sm.full_v[st], KV_BYTES);
                tma_load(sm.v[st], &tv, &sm.full_v[st], h, t * BKV, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
        consume(sm, a, threadIdx.x / 128 - 1, q0, b, h, tiles);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// The (D, H, N, B) tensor map of q, k or v: `st` holds the element strides
// (batch, row, head). A dim of size 1 is never stepped over, so it gets a
// packed stride whatever the caller's (TMA takes non-zero multiples of 16 B).
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, const long long* st, int batch, int n, int heads,
                cuuint32_t box_rows) {
    const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(batch)};
    cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2, static_cast<cuuint64_t>(st[1]) * 2,
                             static_cast<cuuint64_t>(st[0]) * 2};
    if (heads == 1) strides[0] = D * 2;
    if (n == 1) strides[1] = strides[0] * heads;
    if (batch == 1) strides[2] = strides[1] * n;
    const cuuint32_t box[4] = {D, 1, box_rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// Launch the kernel on the current device. Pointers and (batch, row, head)
// element strides as flash_attention.cu's Args carries them; the caller has
// checked 16-byte alignment of every base and stride. Returns the error of
// the tensor-map encode (a CUresult, whose codes agree with cudaError_t's
// for invalid values) or of the launch.
cudaError_t flash_attention_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                                 const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads,
                                 float qk_scale_log2, cudaStream_t stream) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    CUresult r = encode(fn, &tq, q, q_st, batch, n, heads, BQ);
    if (r == CUDA_SUCCESS) r = encode(fn, &tk, k, k_st, batch, n, heads, BKV);
    if (r == CUDA_SUCCESS) r = encode(fn, &tv, v, v_st, batch, n, heads, BKV);
    if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(r);
    // the dynamic shared memory limit, once per device
    static std::atomic<unsigned long long> configured{0};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (bit == 0 || !(configured.load() & bit)) {
        err = cudaFuncSetAttribute(fa_sm90_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return err;
        configured.fetch_or(bit);
    }
    const Out out{static_cast<__nv_bfloat16*>(o), o_st[0], o_st[1], o_st[2], n, qk_scale_log2};
    const dim3 grid((n + BQ - 1) / BQ, heads, batch);
    fa_sm90_bf16<<<grid, THREADS, SMEM_BYTES, stream>>>(tq, tk, tv, out);
    return cudaGetLastError();
}

// The kernel's resources, for a report: registers per thread at launch
// (before setmaxnreg), local memory (spill) bytes per thread, static and
// dynamic shared memory bytes, threads per block. Returns the cudaError_t.
extern "C" int mdpt_flash_attention_sm90_info(int* out) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, fa_sm90_bf16);
    if (err != cudaSuccess) return (int)err;
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)at.sharedSizeBytes;
    out[3] = SMEM_BYTES;
    out[4] = at.maxThreadsPerBlock;
    return 0;
}
