// SwinV2 window attention for Hopper (sm_90a) in bfloat16, with the
// continuous-position bias (CPB) and the shift mask kept factored: wgmma, TMA
// and a warp-specialised producer. Every launch of mdpt_window_attention
// (csrc/window_attention.cu) whose q, k, v, CPB and mask are bfloat16 and
// whose layouts a tensor map can read runs here (template MASK: with or
// without the shift mask); the float32 launches, bfloat16 activations with
// float32 biases and layouts TMA cannot read stay in window_attention.cu.
//
// Replaces the TPU kernel muggled_dpt_tpu/ops/pallas/window_attention.py
// window_flash_attention (:58) -> _kernel (:31). Per batch b, window w and
// head h:
//   out[b, w, i, h, :] = sum_j softmax_j(q_i . k_j + cpb[h, i, j] + mask[w, i, j]) v_j,   D = 32,
// on (B, nW, A, H, D) q, k, v and out read and written in place through
// (batch, window, row, head) strides: q arrives l2-normalized times the
// block's logit scale, k l2-normalized, so there is no scale. cpb is (H, A,
// A) and mask (nW, A, A), read by (head or window, row) strides: their
// (B, nW, H, A, A) sum is never built.
//
// Bound on an H100 SXM. Each (q, k) pair costs 4 D = 128 tensor-core FLOPs
// and one exp2 on the SFU: at 989 TFLOP/s the products run at 7.7e12 pairs/s,
// the SFU (16 ex2 per clock per SM, 132 SMs, 1.83 GHz) at 3.86e12. At D = 32
// the exp is the bound, about 1.7x the bytes (q, k, v, out and the two bias
// tables read once over HBM) and 2x the products, and the FP32 pipe is close
// behind it: per logit two bias adds, the max, one FFMA, the row sum and half
// a pack. Close behind that is the bias traffic from L2 to the SMs: each CTA
// reads its q tile's rows of the CPB and of the mask for every key, 192 x A x
// 2 B each, three times what it reads of K and V; over SwinV2-L-384's stage 1
// at B=8 about 1.0 GB. Both tables are the same for every batch element.
// Measured on an H100 (tools/window_sm90_variants.py, PERF.md): the loads
// alone take 0.42x the kernel's time at stage 1 (12 TB/s from L2), the
// consumers' work alone 0.98x; so the consumers' chain per key tile bounds
// it, the softmax most (without it 0.42x), no part of it alone (the bias
// reads from shared memory, the exp2, the max, the products) above a fifth.
//
// Design (one CTA per batch element, 192-row q tile, window and head; 4
// warpgroups, 512 threads):
//   * producer warpgroup: gives up registers (setmaxnreg.dec); one thread
//     issues TMA: the 192 x 32 Q tile once, then, into a ring of STAGES
//     stages, K and V tiles of BKV keys and the tile's 192 x BKV CPB (and, in
//     the MASK instantiation, mask) tiles, each operand with a full and an
//     empty mbarrier. q, k, v and out are 5-D tensor maps (D, H, A, nW, B)
//     over the caller's strides with the 64-byte swizzle (a D = 32 bf16 row
//     is 64 bytes); the CPB map is (A, A, H) and the mask's (A, A, nW), boxes
//     of 64 keys (one 128-byte swizzle row) over the logical A, so a padded
//     row's pads are never read. Rows and keys past A arrive as zeros.
//   * three consumer warpgroups of 64 q rows (setmaxnreg.inc): S = Q K^T by
//     wgmma m64nBKVk16, two k steps over D = 32, both operands from shared
//     memory through K-major 64B-swizzle descriptors; the online softmax on
//     the f32 accumulator: t = s + cpb + mask in f32 from the bf16 tiles, read
//     in S's fragment layout by ldmatrix.x4 (conflict-free under the 128B
//     swizzle), the max taken on t, p = exp2(t log2(e) - m); P packed to bf16
//     in registers, which is wgmma's A fragment; O += P V by wgmma m64n32k16,
//     V MN-major through the descriptor's transpose bit, in one 64B swizzle
//     atom. Tile t's QK^T and tile t-1's PV are issued together and tile t's
//     softmax runs while the PV is in flight; the three consumers issue
//     freely, so one's exp2 runs under another's products and waits.
//     Holding tile t+1's QK^T in flight under tile t's softmax (two S
//     register arrays) was tried on an H100 and gave nothing, and drew
//     ptxas's C7512 unless PV_{t-1} was waited for first.
//   * the epilogue writes O, normalized and rounded to bf16, into the
//     consumer's own 64 rows of the Q tile (free once its last QK^T is done)
//     and stores them by TMA through the out map, which drops rows past A.
//   * grid (batch, q tile, window x head), batch fastest: the CTAs that read
//     the same CPB and mask tiles run together, so those tiles come from L2
//     and not from HBM. Loading each bias tile once per thread-block cluster
//     of consecutive batch elements and multicasting it to the cluster (the
//     "cluster 2" variant of tools/window_sm90_variants.py) measured 1.5-1.8x
//     slower on an H100 at every SwinV2-L-384 stage (PERF.md).
//   * at SwinV2's A = 576 = 3 x 192 = 9 x 64 no tile is ragged. A ragged last
//     key tile runs the full tile, its keys past A masked by index: a wgmma
//     issued under a runtime condition makes ptxas serialize every wgmma of
//     the kernel (C7520).
// Numerics kept from the TPU kernel and csrc/window_attention.cu: logits,
// softmax and accumulation in f32 (exp2 domain); keys at or past A masked by
// index (-inf: left out of the max, p = 0), never a pad-count correction; l
// summed from the f32 p; p rounded to bf16 before PV; out = acc / max(l,
// 1e-30), rounded to bf16; q rows past A are computed on zeros and never
// written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int D = 32;              // head dim: one 64-byte swizzle row of bf16
constexpr float NEG_INF = -1e30f;  // the JAX package's masking constant
constexpr float LOG2E = 1.4426950408889634f;
constexpr int CONSUMERS = 3;       // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;  // q rows per CTA
constexpr int BKV = 64;            // keys per K / V / bias tile
constexpr int BOXES = BKV / 64;    // bias boxes of 64 keys per tile
constexpr int STAGES = 3;          // K / V / bias ring depth
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup, then the consumers
// registers per thread after setmaxnreg: the producer gives up what the consumers take
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 160;
constexpr int CTA_REGS = 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
static_assert(CTA_REGS <= 65536, "the register file holds one CTA");
constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;  // one bf16 tile of q, of k or of v
constexpr uint32_t BIAS_BYTES = BQ * BKV * 2;                     // one CPB or mask tile
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;  // each arrives once on an empty barrier
constexpr long long WAIT_LIMIT = 1ll << 35;    // clocks (about 18 s): a wait this long is a fault, not a wait

template <bool MASK>
struct MaskStages {};

template <>
struct MaskStages<true> {
    alignas(1024) __nv_bfloat16 tile[STAGES][BQ * BKV];
};

template <bool MASK>
struct Smem {  // at a 1024-byte aligned address: the 128B swizzle repeats every 1024 bytes, the 64B one every 512
    // stage st: keys 0-63 of the tile as 192 swizzled rows of 128 B, then keys 64-127 (BKV = 128)
    alignas(1024) __nv_bfloat16 cpb[STAGES][BQ * BKV];
    alignas(1024) __nv_bfloat16 q[BQ * D];  // then, per consumer, its 64 rows of out
    alignas(1024) __nv_bfloat16 k[STAGES][BKV * D];
    alignas(1024) __nv_bfloat16 v[STAGES][BKV * D];
    MaskStages<MASK> mask;
    uint64_t full_q, full_k[STAGES], full_v[STAGES], full_b[STAGES], empty_k[STAGES], empty_v[STAGES], empty_b[STAGES];
};
template <bool MASK>
constexpr int SMEM_BYTES = sizeof(Smem<MASK>) + 1024;  // slack to align the base

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

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// Wait until the phase of parity `parity` has completed; trap (a launch
// failure the caller sees) rather than hang if it never does.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    if (mbar_try(bar, parity)) return;
    const long long start = clock64();
    while (!mbar_try(bar, parity))
        if (clock64() - start > WAIT_LIMIT) __trap();
}

// One box of a 5-D tensor map at (c0, .., c4), innermost first, into shared memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2, int c3, int c4) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
        : "memory");
}

// One box of a 3-D tensor map at (c0, c1, c2) into shared memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// Shared memory to the box of a 5-D tensor map at (c0, .., c4); elements past the map's edges are dropped.
__device__ __forceinline__ void tma_store5(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3, int c4) {
    asm volatile("cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map)),
                 "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the source stays valid until read
}

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

template <int J>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// wgmma descriptor of a 64B-swizzled tile of 64-byte rows (D = 32 bf16):
// start address >> 4, leading byte offset 1 (unused: one swizzle atom spans
// the K extent of a K-major step and the N extent of the MN-major V), stride
// byte offset 512 B >> 4 (from one 8-row group to the next), swizzle mode 2
// (64B). The K-major Q and K tiles and the MN-major V tile share it; a k
// step moves the start address (Q, K: 32 bytes along the row; V: 16 rows).
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

#define ACC8(i) \
    "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 rows x 64 keys, f32) = or += A (64 x 16 of D) B^T (64 keys x 16 of D), both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 rows x 32, f32) += A (64 x 16 keys, bf16 registers) B (16 keys x 32, MN-major in shared memory)
__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : ACC8(0), ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef ACC8

// Four 8x8 bf16 matrices of shared memory, one row address per lane (lanes
// 8m..8m+7: matrix m); register m gets this lane's pair of matrix m in the
// mma C-fragment layout: row lane / 4, columns 2 (lane % 4) and + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int SN = BKV / 2;   // S registers per thread
constexpr int PJ = BKV / 16;  // PV k steps per tile

// S = Q K^T over D = 32: two k steps of 16 (32 bytes along the swizzled rows)
__device__ __forceinline__ void issue_qk(float (&s)[SN], uint64_t dq, const __nv_bfloat16* k_tile) {
    const uint64_t dk = sw64_desc(k_tile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// O += P V over BKV keys: k steps of 16 keys (16 rows of 64 B = 1024 B)
__device__ __forceinline__ void issue_pv(float (&o)[16], const uint32_t (&p)[PJ][4], const __nv_bfloat16* v_tile) {
    const uint64_t dv = sw64_desc(v_tile);
#pragma unroll
    for (int j = 0; j < PJ; ++j) wgmma_pv(o, p[j], dv + j * (16 * 64 >> 4));
}

// This thread holds rows g and g + 8 of its warp's 16 in an S tile:
// s[4i + e] is row g + 8 (e >> 1), key kbase + 8i + 2c + (e & 1).
__device__ __forceinline__ bool key_masked(int kbase, int i, int e, int c, int n) { return kbase + 8 * i + 2 * c + (e & 1) >= n; }

// The online softmax of one S tile in place, exp2 domain: t = s + cpb (+
// mask), each read from its bias stage by ldmatrix at this lane's row
// address (see consume); keys at or past A (TAIL: the last tile) set to
// -inf. On return s holds the f32 p = exp2(t log2(e) - m), m the new row max
// of the logits (log2 units), alpha the factor for the old accumulator, l the
// rescaled partial row sum.
template <bool MASK, bool TAIL>
__device__ __forceinline__ void online_softmax(float (&s)[SN], float (&m)[2], float (&l)[2], float (&alpha)[2], uint32_t cpb_addr,
                                               uint32_t mask_addr, int kbase, int n, int c) {
    float mx[2] = {-INFINITY, -INFINITY};
    // ldmatrix x4 at key blocks i and i + 1: registers (row g, i), (g + 8, i), (g, i + 1), (g + 8, i + 1)
#pragma unroll
    for (int i = 0; i < BKV / 8; i += 2) {
        const uint32_t step = (i / 8) * (BQ * 128);  // the box of 64 keys
        uint32_t cb[4], mb[4];
        ldsm_x4(cb, (cpb_addr ^ ((i % 8) << 4)) + step);
        if constexpr (MASK) ldsm_x4(mb, (mask_addr ^ ((i % 8) << 4)) + step);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int ii = i + (e >> 2), ee = e & 3, reg = 2 * (e >> 2) + (ee >> 1);
            float t = s[4 * ii + ee] + ((ee & 1) ? bf16_hi(cb[reg]) : bf16_lo(cb[reg]));
            if constexpr (MASK) t += (ee & 1) ? bf16_hi(mb[reg]) : bf16_lo(mb[reg]);
            s[4 * ii + ee] = TAIL && key_masked(kbase, ii, ee, c, n) ? -INFINITY : t;
            mx[ee >> 1] = fmaxf(mx[ee >> 1], s[4 * ii + ee]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * LOG2E);  // the max of the logits, log2 units
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < SN; ++i) {
        s[i] = ex2(fmaf(s[i], LOG2E, -m[(i >> 1) & 1]));  // a masked -inf gives 0
        l[(i >> 1) & 1] += s[i];
    }
}

template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[SN], float (&m)[2], float (&l)[2], float (&alpha)[2], uint32_t cpb_addr,
                                             uint32_t mask_addr, int kbase, int n, int c) {
    if (kbase + BKV <= n) {
        online_softmax<MASK, false>(s, m, l, alpha, cpb_addr, mask_addr, kbase, n, c);
    } else {
        online_softmax<MASK, true>(s, m, l, alpha, cpb_addr, mask_addr, kbase, n, c);
    }
}

// P in bf16: the S fragments of keys 16j..16j+15 are the A fragment of PV k step j
__device__ __forceinline__ void pack_p(uint32_t (&p)[PJ][4], const float (&s)[SN]) {
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[j][i] = pack_bf16(s[8 * j + 2 * i], s[8 * j + 2 * i + 1]);
    }
}

__device__ __forceinline__ void rescale(float (&o)[16], const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
    if (lane == 0) mbar_arrive(bar);
}

// Consumer warpgroup `wg`: q rows q0 + 64 wg .. + 63 over every key tile.
template <bool MASK>
__device__ __forceinline__ void consume(Smem<MASK>& sm, const CUtensorMap* to, int wg, int b, int q0, int w, int h, int n,
                                        int tiles) {
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const uint64_t dq = sw64_desc(sm.q + wg * 64 * D);
    // This lane's ldmatrix row address in bias stage 0: matrix lane / 8 is
    // (row g + 8 (lane / 8 % 2), key block i + lane / 16), its row lane % 8;
    // the 128B swizzle puts 16-byte chunk j of row r at j ^ (r % 8), and the
    // key block's chunk (i % 8, i even) is XORed in per load.
    const int mi = lane / 8, r8 = lane % 8;
    const uint32_t lane_off = (wg * 64 + warp * 16 + (mi & 1) * 8 + r8) * 128 + (((mi >> 1) ^ r8) << 4);
    const uint32_t cpb_lane = smem_u32(sm.cpb[0]) + lane_off;
    uint32_t mask_lane = 0;
    if constexpr (MASK) mask_lane = smem_u32(sm.mask.tile[0]) + lane_off;
    float s[SN], o[16], alpha[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t p[PJ][4];
#pragma unroll
    for (int i = 0; i < SN; ++i) s[i] = 0.f;  // overwritten by the first k step; keeps the operand defined
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;

    mbar_wait(&sm.full_q, 0);

    // key tile 0: S only
    mbar_wait(&sm.full_k[0], 0);
    wgmma_fence();
    issue_qk(s, dq, sm.k[0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(&sm.empty_k[0], lane);
    mbar_wait(&sm.full_b[0], 0);
    softmax_tile<MASK>(s, m, l, alpha, cpb_lane, mask_lane, 0, n, c);
    release(&sm.empty_b[0], lane);
    pack_p(p, s);

    // key tile t: S_t and PV_{t-1} issued together, softmax_t under PV_{t-1}
    for (int t = 1; t < tiles; ++t) {
        const int st = t % STAGES, pst = (t - 1) % STAGES;
        const uint32_t parity = (t / STAGES) & 1;
        mbar_wait(&sm.full_k[st], parity);
        mbar_wait(&sm.full_v[pst], ((t - 1) / STAGES) & 1);
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_qk(s, dq, sm.k[st]);
        wgmma_commit();
        issue_pv(o, p, sm.v[pst]);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        release(&sm.empty_k[st], lane);
        mbar_wait(&sm.full_b[st], parity);
        softmax_tile<MASK>(s, m, l, alpha, cpb_lane + st * BIAS_BYTES, mask_lane + st * BIAS_BYTES, t * BKV, n, c);
        release(&sm.empty_b[st], lane);
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
    wgmma_fence();
    issue_pv(o, p, sm.v[pst]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    // out = O / l in bf16, staged in this consumer's 64 rows of the Q tile
    // (its last QK^T is done) where the out map's 64B swizzle wants them:
    // chunk j of row r at j ^ (r / 2 % 4); then one TMA store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    uint8_t* stage = reinterpret_cast<uint8_t*>(sm.q + wg * 64 * D);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint32_t*>(stage + row * 64 + ((i ^ ((row >> 1) & 3)) << 4) + 4 * c) =
                pack_bf16(o[4 * i + 2 * r] / lr, o[4 * i + 2 * r + 1] / lr);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");        // the generic writes, visible to TMA
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");          // this warpgroup's rows are all written
    if (tid == 0) tma_store5(to, stage, 0, h, q0 + wg * 64, w, b);
}

template <bool MASK>
__device__ __forceinline__ void produce(Smem<MASK>& sm, const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                        const CUtensorMap* tc, const CUtensorMap* tm, int b, int q0, int w, int h, int tiles) {
    mbar_expect_tx(&sm.full_q, Q_BYTES);
    tma_load5(sm.q, tq, &sm.full_q, 0, h, q0, w, b);
    for (int t = 0; t < tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;  // the first pass finds every stage free
        mbar_wait(&sm.empty_k[st], free_parity);
        mbar_expect_tx(&sm.full_k[st], KV_BYTES);
        tma_load5(sm.k[st], tk, &sm.full_k[st], 0, h, t * BKV, w, b);
        mbar_wait(&sm.empty_b[st], free_parity);
        mbar_expect_tx(&sm.full_b[st], (MASK ? 2 : 1) * BIAS_BYTES);
#pragma unroll
        for (int box = 0; box < BOXES; ++box) {
            const int offset = box * BQ * 64, key = t * BKV + 64 * box;
            tma_load3(sm.cpb[st] + offset, tc, &sm.full_b[st], key, q0, h);
            if constexpr (MASK) tma_load3(sm.mask.tile[st] + offset, tm, &sm.full_b[st], key, q0, w);
        }
        mbar_wait(&sm.empty_v[st], free_parity);
        mbar_expect_tx(&sm.full_v[st], KV_BYTES);
        tma_load5(sm.v[st], tv, &sm.full_v[st], 0, h, t * BKV, w, b);
    }
}

template <bool MASK>
__global__ void __launch_bounds__(THREADS, 1)
    wa_sm90_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tm, const int n, const int heads) {
    extern __shared__ uint8_t smem_raw[];
    Smem<MASK>& sm = *reinterpret_cast<Smem<MASK>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
    const int b = blockIdx.x, q0 = blockIdx.y * BQ;  // batch fastest
    const int w = blockIdx.z / heads, h = blockIdx.z - w * heads;
    const int tiles = (n + BKV - 1) / BKV;

    if (threadIdx.x == 0) {
        mbar_init(&sm.full_q, 1);
#pragma unroll
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(&sm.full_k[st], 1);
            mbar_init(&sm.full_v[st], 1);
            mbar_init(&sm.full_b[st], 1);
            mbar_init(&sm.empty_k[st], CONSUMER_WARPS);
            mbar_init(&sm.empty_v[st], CONSUMER_WARPS);
            mbar_init(&sm.empty_b[st], CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every TMA load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) produce<MASK>(sm, &tq, &tk, &tv, &tc, &tm, b, q0, w, h, tiles);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
        consume<MASK>(sm, &to, threadIdx.x / 128 - 1, b, q0, w, h, n, tiles);
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

// A bf16 tensor map of RANK dims, zeros past the edges. `stride` holds the
// byte strides of dims 1 .. RANK-1; a dim of size 1 is never stepped over, so
// it gets a packed stride whatever the caller's (TMA takes non-zero
// multiples of 16 B).
template <int RANK>
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[RANK], cuuint64_t (&stride)[RANK - 1],
                const cuuint32_t (&box)[RANK], CUtensorMapSwizzle swizzle) {
    for (int i = 0; i < RANK - 1; ++i)
        if (dims[i + 1] == 1) stride[i] = i == 0 ? (dims[0] * 2 + 15) / 16 * 16 : stride[i - 1] * dims[i];
    cuuint32_t unit[RANK];
    for (int i = 0; i < RANK; ++i) unit[i] = 1;
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, RANK, const_cast<void*>(ptr), dims, stride, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The (D, H, A, nW, B) tensor map of q, k, v or out: `st` holds the element
// strides (batch, window, row, head); boxes of `rows` rows of one head.
CUresult encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, const long long* st, int batch, int nw, int n, int heads,
                     cuuint32_t rows) {
    const cuuint64_t dims[5] = {D, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(nw),
                                static_cast<cuuint64_t>(batch)};
    cuuint64_t stride[4] = {static_cast<cuuint64_t>(st[3]) * 2, static_cast<cuuint64_t>(st[2]) * 2,
                            static_cast<cuuint64_t>(st[1]) * 2, static_cast<cuuint64_t>(st[0]) * 2};
    return encode<5>(fn, map, ptr, dims, stride, {D, 1, rows, 1, 1}, CU_TENSOR_MAP_SWIZZLE_64B);
}

// The (A, A, count) tensor map of the CPB (count = H) or the mask (count =
// nW): the logical A in both dims, so a padded row's pads read as zeros and
// are never fetched; `st` holds the element strides (head or window, row).
// Boxes of 64 keys x `rows` q rows.
CUresult encode_bias(EncodeTiled fn, CUtensorMap* map, const void* ptr, const long long* st, int n, int count, cuuint32_t rows) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(count)};
    cuuint64_t stride[2] = {static_cast<cuuint64_t>(st[1]) * 2, static_cast<cuuint64_t>(st[0]) * 2};
    return encode<3>(fn, map, ptr, dims, stride, {64, rows, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Maps {
    CUtensorMap q, k, v, o, cpb, mask;
};

template <bool MASK>
cudaError_t launch(const Maps& m, int batch, int nw, int n, int heads, cudaStream_t stream) {
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
        err = cudaFuncGetAttributes(&at, wa_sm90_bf16<MASK>);
        if (err != cudaSuccess) return err;
        if (at.numRegs * THREADS < CTA_REGS) return cudaErrorInvalidConfiguration;
        err = cudaFuncSetAttribute(wa_sm90_bf16<MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES<MASK>);
        if (err != cudaSuccess) return err;
        configured.fetch_or(bit);
    }
    const dim3 grid(batch, (n + BQ - 1) / BQ, nw * heads);
    wa_sm90_bf16<MASK><<<grid, THREADS, SMEM_BYTES<MASK>, stream>>>(m.q, m.k, m.v, m.o, m.cpb, m.mask, n, heads);
    return cudaGetLastError();
}

}  // namespace

// Launch the kernel on the current device. q, k, v and out: addresses and
// (batch, window, row, head) element strides, the head dim contiguous; cpb:
// address and (head, row) element strides; mask: null, or address and
// (window, row) element strides; columns contiguous. The caller has checked
// that a tensor map reads every operand (csrc/window_attention.cu:
// tma_readable). Returns the error of a tensor-map encode (a CUresult, whose
// codes agree with cudaError_t's for invalid values) or of the launch.
cudaError_t window_attention_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                                  const long long* v_st, void* o, const long long* o_st, const void* cpb, const long long* c_st,
                                  const void* mask, const long long* m_st, int batch, int nw, int n, int heads,
                                  cudaStream_t stream) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    Maps m{};
    CUresult r = encode_rows(fn, &m.q, q, q_st, batch, nw, n, heads, BQ);
    if (r == CUDA_SUCCESS) r = encode_rows(fn, &m.k, k, k_st, batch, nw, n, heads, BKV);
    if (r == CUDA_SUCCESS) r = encode_rows(fn, &m.v, v, v_st, batch, nw, n, heads, BKV);
    if (r == CUDA_SUCCESS) r = encode_rows(fn, &m.o, o, o_st, batch, nw, n, heads, 64);
    if (r == CUDA_SUCCESS) r = encode_bias(fn, &m.cpb, cpb, c_st, n, heads, BQ);
    if (r == CUDA_SUCCESS && mask != nullptr) r = encode_bias(fn, &m.mask, mask, m_st, n, nw, BQ);
    if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(r);
    return mask != nullptr ? launch<true>(m, batch, nw, n, heads, stream) : launch<false>(m, batch, nw, n, heads, stream);
}

// An instantiation's resources, for a report: `mask` 0 (no mask) or 1;
// out: registers per thread at launch (before setmaxnreg), local memory
// (spill) bytes per thread, static and dynamic shared memory bytes, threads
// per block. Returns the cudaError_t.
extern "C" int mdpt_window_attention_sm90_info(int mask, int* out) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, mask ? wa_sm90_bf16<true> : wa_sm90_bf16<false>);
    if (err != cudaSuccess) return (int)err;
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)at.sharedSizeBytes;
    out[3] = mask ? SMEM_BYTES<true> : SMEM_BYTES<false>;
    out[4] = at.maxThreadsPerBlock;
    return 0;
}
