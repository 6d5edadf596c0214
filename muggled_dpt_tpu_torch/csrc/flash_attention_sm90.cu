// Bfloat16 and float16 flash attention for Hopper (sm_90a), with or without
// an additive bias of the same type: wgmma, TMA and a warp-specialised
// producer. Every bfloat16 or float16 launch of mdpt_flash_attention
// (csrc/flash_attention.cu) whose bias is absent or of q's type runs here
// (template fa_sm90<T, BIAS>: T __nv_bfloat16 or __half, BIAS_NONE or
// BIAS_ELEM, over one producer and one consumer); a float32 bias and the
// float32 launches stay in flash_attention.cu. The two element types share
// every line but the wgmma type strings, the tensor maps' data type and the
// packs and unpacks of sm90_attention.cuh's Elem<T>.
//
// Replaces the TPU kernels of muggled_dpt_tpu/ops/pallas/flash_attention.py
// that compute this function on differently laid-out inputs:
//   #1 flash_attention_fused_qkv (:310), unbiased -> _onepass_qkv_kernel (:125)
//   #2 the same, biased: bias (:472-478) or bias_stack + layer (:434-464)
//   #4 flash_attention (:791), the (B, N, H, D) op -> _onepass_kernel (:86)
//   #5 _flash_bhnd_prescaled online                -> _online_kernel (:497)
// Per batch b and head h it computes
//   out[b, i, h, :] = sum_j softmax_j(q_i . k_j * scale + bias[b, h, i, j]) v_j,   D = 64,
// q, k and v read in place through (batch, row, head) strides: the fused
// qkv slab's 3C / 3D, or a (B, N, H, D) view's own; the bias through (batch,
// head, row, column) strides, 0 where it broadcasts, from a base that may be
// one layer of BEiT's cached (L, H, Np, Np) stack.
//
// Bound on an H100 SXM: each (q, k) pair costs 4 D = 256 tensor-core FLOPs
// (QK^T and PV) and one exp2 on the SFU. At 989 TFLOP/s bf16 or f16 and 16 ex2 per
// clock per SM (132 SMs, 1.83 GHz) both rates are 3.86e12 pairs/s: at D = 64
// the exp is a co-bound of the products, so the kernel has to overlap the
// softmax with the GEMMs to get near either. The bytes (q, k, v and a bias
// layer read once, out written once) are below both; what is not is the K/V
// traffic from L2, N^2 H B * 256 B / BQ, which a taller q tile divides, and a
// bias that broadcasts over the batch, read from HBM once per batch element
// unless the CTAs that share it run together.
//
// Design (one CTA per 192 q rows, head and batch; 4 warpgroups):
//   * producer warpgroup: gives up registers (setmaxnreg.dec); one thread
//     issues TMA: the 192 x 64 Q tile once, then K and V tiles of 128 keys
//     (and the tile's 192 x 128 bias) into a ring of STAGES stages, each with
//     a full and an empty mbarrier per operand. The tensor maps are 4-D,
//     (D, H, N, B) for q, k, v and (N, N, H, B) for the bias, with the
//     caller's byte strides and 128-byte swizzle, encoded on the host per
//     launch; rows and columns past N arrive as zeros (a pre-padded bias's
//     pads are never read), a dim the bias broadcasts over is a dim of size
//     1 at coordinate 0. A bias TMA cannot read (a column stride other than
//     1, a base or stride off 16 bytes, a broadcast row) is copied instead by
//     the producer's other three warps with plain loads at any stride, into
//     the same swizzled layout, arriving on the same full barrier; the
//     wrapper chooses the fill from the bias's layout.
//   * three consumer warpgroups of 64 q rows (setmaxnreg.inc 160):
//     S = Q K^T by wgmma m64n128k16, both operands from shared memory
//     through descriptors (K-major, 128B swizzle); the online softmax on
//     the f32 accumulator in registers (its layout repeats mma.sync's
//     m16n8 C fragment per warp: row max by two shuffles); P packed to T
//     in place, which is wgmma's register A fragment; O += P V by wgmma
//     m64n64k16 with A from registers and V from shared memory, transposed
//     by the descriptor (V is stored [key][d], MN-major). The bias tile is
//     read in the S fragment's own layout by ldmatrix (x4: rows g and g + 8
//     of two 8-key blocks), conflict-free under the swizzle, four registers
//     at a time just before they are added.
//   * overlap: tile t's QK^T and tile t-1's PV are issued together; the
//     softmax of tile t runs while PV t-1 is in flight (a K stage is
//     released once its S is done, a bias stage once its softmax is, a V
//     stage once its PV is). The three consumers issue freely, so one's
//     softmax runs under the others' tensor-core work without turns (named
//     barriers in turn cost 1-10 % on an H100; PERF.md).
//   * grid (batch, q tile, head), batch fastest: the B CTAs that read one
//     head's q tile of a batch-broadcast bias run back to back, so each bias
//     tile comes from HBM once and from L2 for the rest; K/V of a (batch,
//     head) stay shared by its q tiles within a wave.
//   * the ragged last key tile runs the full 128-key softmax and PV, keys
//     past N masked: a wgmma issued under a runtime condition makes ptxas
//     serialize every wgmma of the kernel (C7520), and a short-tail
//     instantiation ran out of registers for the wgmma pipeline (C7511);
//     each cost more than the tail's work (PERF.md).
//   Three consumers (192 q rows) rather than two (128): a third less K/V
//   traffic from L2 and one more warp per sub-partition to hide the exp2
//   and the waits; 160 registers still hold S, O and P without spills
//   (measured on an H100: 13-17 % faster than two consumers at DA-V2
//   ViT-L's shapes; PERF.md).
// Numerics kept from the TPU kernels and csrc/flash_attention.cu:
//   * exp2 domain. Unbiased: the logit s * scale * log2(e) folded with the
//     row max into one FFMA (the max taken on raw s, on -s for a negative
//     scale). Biased: t = s * scale + bias in f32 from the T bias, the max
//     taken on t, p = exp2(t * log2(e) - m); q is not rounded a second time;
//   * keys at or past N are masked by index (TMA's zero rows would give
//     logit 0, not -inf), whatever the bias holds there: left out of the max
//     and given p = 0, never a pad-count correction;
//   * l summed from the f32 p; p rounded to T before PV (in f16 a p below
//     2^-24 rounds to 0 where bf16 keeps it; l, summed from the f32 p, does
//     not lose it, as the plain version's f32 softmax does not);
//     out = acc / max(l, 1e-30), rounded to T (in f16 never out of range: out
//     is a convex combination of v's rows, p lies in [0, 1]);
//   * q rows past N are computed on zeros and never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90_attention.cuh"

namespace {

constexpr int BIAS_NONE = 0, BIAS_ELEM = 1;       // template argument BIAS: none, or a bias of q's type T
constexpr int FILL_TMA = 0, FILL_COPY = 1;        // how a bias stage is filled (the wrapper's choice)
constexpr int CONSUMERS = 3;       // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;  // q rows per CTA
constexpr int BKV = 128;           // keys per K / V / bias tile
constexpr int STAGES = 2;          // K / V / bias ring depth
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup, then the consumers
constexpr int COPY_THREADS = 96;   // the producer's warps 1-3: the bias copy
// registers per thread after setmaxnreg: the producer gives up what the consumers take
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 160;
constexpr int CTA_REGS = 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
static_assert(CTA_REGS <= 65536, "the register file holds one CTA");
constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;  // one 16-bit tile of q, of k or of v
constexpr uint32_t BIAS_BYTES = BQ * BKV * 2;                     // one bias tile: two boxes of 64 keys x 192 rows
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;  // each arrives once on an empty barrier

template <typename T, int BIAS>
struct BiasStages {};

template <typename T>
struct BiasStages<T, BIAS_ELEM> {
    // stage st: keys 0-63 of the tile as 192 swizzled rows of 128 B, then keys 64-127
    T tile[STAGES][BQ * BKV];
    uint64_t full[STAGES], empty[STAGES];
};

template <typename T, int BIAS>
struct Smem {  // at a 1024-byte aligned address: the 128B swizzle repeats every 8 rows
    T q[BQ * D];
    T k[STAGES][BKV * D];
    T v[STAGES][BKV * D];
    BiasStages<T, BIAS> bias;
    uint64_t full_q, full_k[STAGES], full_v[STAGES], empty_k[STAGES], empty_v[STAGES];
};
template <typename T, int BIAS>
constexpr int SMEM_BYTES = sizeof(Smem<T, BIAS>) + 1024;  // slack to align the base

template <typename T>
struct Params {
    T* o;
    long long sb, sn, sh;  // out's element strides: batch, row, head
    const T* bias;     // the bias's element (0, 0, 0, 0), or null
    long long b_sb, b_sh, b_sn, b_sk;  // its element strides: batch, head, row, column (0: broadcast)
    int n;
    int fill;
    float qk_scale_log2;
};

// Four 8x8 matrices of 16-bit elements in shared memory, one row address per lane (lanes
// 8m..8m+7: matrix m); register m gets this lane's pair of matrix m in the
// mma C-fragment layout: row lane / 4, columns 2 (lane % 4) and + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(addr)
                 : "memory");
}

// The online softmax of one S tile in place, exp2 domain. Keys at or past
// N (MASK: the last tile) count in neither the max nor the sum. Unbiased:
// the logit of s is s * scale_log2, folded with the row max into one FFMA
// per element. Biased: t = s * scale + b, with b read from the bias tile by
// ldmatrix at `bias_addr` (this lane's row address in the stage, see
// consume), and p = exp2(t * log2(e) - m). On return s holds the f32 p, m
// the new row max of the logits (log2 units), alpha the factor for the old
// accumulator, l the rescaled partial row sum.
template <typename T, int BIAS, bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                               float scale, uint32_t bias_addr, int kbase, int n, int c) {
    float mx[2] = {-INFINITY, -INFINITY};
    if constexpr (BIAS == BIAS_NONE) {
        if (scale_log2 >= 0.f) {
            row_max<MASK, false>(s, mx, kbase, n, c);
        } else {
            row_max<MASK, true>(s, mx, kbase, n, c);
        }
    } else {
        // ldmatrix x4 at key blocks i and i + 1: registers (row g, i), (g + 8, i), (g, i + 1), (g + 8, i + 1)
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
            uint32_t b[4];
            ldsm_x4(b, (bias_addr ^ ((i % 8) << 4)) + (i / 8) * (BQ * 128));
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int ii = i + (e >> 2), ee = e & 3;
                const uint32_t raw = b[2 * (e >> 2) + (ee >> 1)];
                const float t = fmaf(s[4 * ii + ee], scale, (ee & 1) ? Elem<T>::hi(raw) : Elem<T>::lo(raw));
                s[4 * ii + ee] = MASK && key_masked(kbase, ii, ee, c, n) ? -INFINITY : t;
                mx[ee >> 1] = fmaxf(mx[ee >> 1], s[4 * ii + ee]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the max of the logits, log2 units
        const float m_new = fmaxf(m[r], BIAS == BIAS_NONE ? mx[r] * fabsf(scale_log2) : mx[r] * LOG2E);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if constexpr (BIAS == BIAS_NONE) {
                const float p = ex2(fmaf(s[4 * i + e], scale_log2, -m[e >> 1]));
                s[4 * i + e] = MASK && key_masked(kbase, i, e, c, n) ? 0.f : p;
            } else {
                s[4 * i + e] = ex2(fmaf(s[4 * i + e], LOG2E, -m[e >> 1]));  // a masked -inf gives 0
            }
            l[e >> 1] += s[4 * i + e];
        }
    }
}

template <typename T, int BIAS>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                             float scale, uint32_t bias_addr, int kbase, int n, int c) {
    if (kbase + BKV <= n) {
        online_softmax<T, BIAS, false>(s, m, l, alpha, scale_log2, scale, bias_addr, kbase, n, c);
    } else {
        online_softmax<T, BIAS, true>(s, m, l, alpha, scale_log2, scale, bias_addr, kbase, n, c);
    }
}

// Consumer warpgroup `wg`: q rows q0 + 64 wg .. + 63 over every key tile.
template <typename T, int BIAS>
__device__ __forceinline__ void consume(Smem<T, BIAS>& sm, const Params<T>& a, int wg, int q0, int b, int h, int tiles) {
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int n = a.n;
    const uint64_t dq = sw128_desc(sm.q + wg * 64 * D);
    const float scale = a.qk_scale_log2 * (1.f / LOG2E);
    // This lane's ldmatrix row address in bias stage 0: matrix lane / 8 is
    // (row g + 8 (lane / 8 % 2), key block i + lane / 16), its row lane % 8;
    // the 128B swizzle puts 16-byte chunk j of row r at j ^ (r % 8), and the
    // key block's chunk (i % 8, i even) is XORed in per load.
    uint32_t bias_lane = 0;
    if constexpr (BIAS == BIAS_ELEM) {
        const int mi = lane / 8, r8 = lane % 8;
        const int row = wg * 64 + warp * 16 + (mi & 1) * 8 + r8;
        bias_lane = smem_u32(sm.bias.tile[0]) + row * 128 + (((mi >> 1) ^ r8) << 4);
    }
    auto bias_addr = [&](int st) { return bias_lane + st * BIAS_BYTES; };

    float s[64], o[32], alpha[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;  // overwritten by the first k step; keeps the operand defined
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    mbar_wait(&sm.full_q, 0);

    // key tile 0: S only
    mbar_wait(&sm.full_k[0], 0);
    wgmma_fence();
    issue_qk(s, dq, sm.k[0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(&sm.empty_k[0], lane);
    if constexpr (BIAS == BIAS_ELEM) mbar_wait(&sm.bias.full[0], 0);
    softmax_tile<T, BIAS>(s, m, l, alpha, a.qk_scale_log2, scale, bias_addr(0), 0, n, c);
    if constexpr (BIAS == BIAS_ELEM) release(&sm.bias.empty[0], lane);
    pack_p<T>(p, s);

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
        if constexpr (BIAS == BIAS_ELEM) mbar_wait(&sm.bias.full[st], parity);
        softmax_tile<T, BIAS>(s, m, l, alpha, a.qk_scale_log2, scale, bias_addr(st), t * BKV, n, c);
        if constexpr (BIAS == BIAS_ELEM) release(&sm.bias.empty[st], lane);
        wgmma_wait<0>();
        fence_regs(o);
        release(&sm.empty_v[pst], lane);
        rescale(o, alpha);
        pack_p<T>(p, s);
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
    const int row_g = q0 + wg * 64 + warp * 16 + g;
    T* ob = a.o + b * a.sb + h * a.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        if (row < n) {
            const float lr = fmaxf(l[r], 1e-30f);
            T* op = ob + row * a.sn;
#pragma unroll
            for (int i = 0; i < 8; ++i)
                *reinterpret_cast<uint32_t*>(op + 8 * i + 2 * c) = Elem<T>::pack(o[4 * i + 2 * r] / lr, o[4 * i + 2 * r + 1] / lr);
        }
    }
}

// The producer's warps 1-3 fill every bias stage with plain loads at any
// strides (FILL_COPY): 16-byte chunks of 8 keys, consecutive threads on
// consecutive chunks of a row, stored where TMA's 128B swizzle would put
// them; elements past N are 0. Each thread arrives on the full barrier.
template <typename T>
__device__ __forceinline__ void copy_bias(Smem<T, BIAS_ELEM>& sm, const Params<T>& a, int b, int h, int q0, int tiles) {
    const int ct = threadIdx.x - 32;
    const int n = a.n;
    const unsigned short* head = reinterpret_cast<const unsigned short*>(a.bias + b * a.b_sb + h * a.b_sh);
    for (int t = 0; t < tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(&sm.bias.empty[st], ((t / STAGES) & 1) ^ 1);
        uint8_t* stage = reinterpret_cast<uint8_t*>(sm.bias.tile[st]);
        for (int chunk = ct; chunk < BQ * BKV / 8; chunk += COPY_THREADS) {
            const int r = chunk / (BKV / 8), j = chunk % (BKV / 8);
            const int row = q0 + r, key = t * BKV + 8 * j;
            uint32_t w[4] = {0u, 0u, 0u, 0u};
            if (row < n) {
                const unsigned short* src = head + row * a.b_sn + key * a.b_sk;
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    if (key + e < n) w[e >> 1] |= static_cast<uint32_t>(src[e * a.b_sk]) << (16 * (e & 1));
            }
            *reinterpret_cast<uint4*>(stage + (j / 8) * (BQ * 128) + r * 128 + (((j % 8) ^ (r % 8)) << 4)) =
                make_uint4(w[0], w[1], w[2], w[3]);
        }
        mbar_arrive(&sm.bias.full[st]);
    }
}

template <typename T, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    fa_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb, const Params<T> a) {
    extern __shared__ uint8_t smem_raw[];
    Smem<T, BIAS>& sm = *reinterpret_cast<Smem<T, BIAS>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
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
            if constexpr (BIAS == BIAS_ELEM) {
                mbar_init(&sm.bias.full[st], a.fill == FILL_TMA ? 1 : COPY_THREADS);
                mbar_init(&sm.bias.empty[st], CONSUMER_WARPS);
            }
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every TMA copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            const bool bias_tma = BIAS == BIAS_ELEM && a.fill == FILL_TMA;
            // a dim the bias broadcasts over is a dim of size 1 in its tensor map
            const int bias_h = a.b_sh != 0 ? h : 0, bias_b = a.b_sb != 0 ? b : 0;
            mbar_expect_tx(&sm.full_q, Q_BYTES);
            tma_load(sm.q, &tq, &sm.full_q, 0, h, q0, b);
            for (int t = 0; t < tiles; ++t) {
                const int st = t % STAGES;
                const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;  // the first pass finds every stage free
                mbar_wait(&sm.empty_k[st], free_parity);
                mbar_expect_tx(&sm.full_k[st], KV_BYTES);
                tma_load(sm.k[st], &tk, &sm.full_k[st], 0, h, t * BKV, b);
                if constexpr (BIAS == BIAS_ELEM) {
                    if (bias_tma) {
                        mbar_wait(&sm.bias.empty[st], free_parity);
                        mbar_expect_tx(&sm.bias.full[st], BIAS_BYTES);
                        tma_load(sm.bias.tile[st], &tb, &sm.bias.full[st], t * BKV, q0, bias_h, bias_b);
                        tma_load(sm.bias.tile[st] + BQ * 64, &tb, &sm.bias.full[st], t * BKV + 64, q0, bias_h, bias_b);
                    }
                }
                mbar_wait(&sm.empty_v[st], free_parity);
                mbar_expect_tx(&sm.full_v[st], KV_BYTES);
                tma_load(sm.v[st], &tv, &sm.full_v[st], 0, h, t * BKV, b);
            }
        } else if constexpr (BIAS == BIAS_ELEM) {
            if (a.fill == FILL_COPY && threadIdx.x >= 32) copy_bias(sm, a, b, h, q0, tiles);
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
        consume<T, BIAS>(sm, a, threadIdx.x / 128 - 1, q0, b, h, tiles);
    }
}

// The (N, N, H, B) tensor map of the bias: the logical N in both dims, so a
// pre-padded bias's pads read as zeros and are never fetched; `st` holds the
// element strides (batch, head, row), 0 where the bias broadcasts: that dim
// has size 1. Boxes of 64 keys x 192 rows.
CUresult encode_bias(EncodeTiled fn, CUtensorMap* map, const void* ptr, const long long* st, int batch, int n, int heads,
                     CUtensorMapDataType type) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(st[1] != 0 ? heads : 1), static_cast<cuuint64_t>(st[0] != 0 ? batch : 1)};
    cuuint64_t stride[3] = {static_cast<cuuint64_t>(st[2]) * 2, static_cast<cuuint64_t>(st[1]) * 2,
                            static_cast<cuuint64_t>(st[0]) * 2};
    return encode4(fn, map, ptr, dims, stride, {64, BQ, 1, 1}, type);
}

template <typename T, int BIAS>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tb, const Params<T>& p,
                   int batch, int heads, cudaStream_t stream) {
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
        err = cudaFuncGetAttributes(&at, fa_sm90<T, BIAS>);
        if (err != cudaSuccess) return err;
        if (at.numRegs * THREADS < CTA_REGS) return cudaErrorInvalidConfiguration;
        err = cudaFuncSetAttribute(fa_sm90<T, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES<T, BIAS>);
        if (err != cudaSuccess) return err;
        configured.fetch_or(bit);
    }
    const dim3 grid(batch, (p.n + BQ - 1) / BQ, heads);
    fa_sm90<T, BIAS><<<grid, THREADS, SMEM_BYTES<T, BIAS>, stream>>>(tq, tk, tv, tb, p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_elem(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                        const long long* v_st, void* o, const long long* o_st, const void* bias, const long long* bias_st,
                        int fill, int batch, int n, int heads, float qk_scale_log2, cudaStream_t stream) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    if (bias != nullptr && fill != FILL_TMA && fill != FILL_COPY) return cudaErrorInvalidValue;
    constexpr CUtensorMapDataType type = Elem<T>::TMA;
    CUtensorMap tq, tk, tv, tb{};
    CUresult r = encode_qkv(fn, &tq, q, q_st, batch, n, heads, BQ, type);
    if (r == CUDA_SUCCESS) r = encode_qkv(fn, &tk, k, k_st, batch, n, heads, BKV, type);
    if (r == CUDA_SUCCESS) r = encode_qkv(fn, &tv, v, v_st, batch, n, heads, BKV, type);
    if (r == CUDA_SUCCESS && bias != nullptr && fill == FILL_TMA) {
        if (bias_st[3] != 1 || bias_st[2] == 0) return cudaErrorInvalidValue;  // TMA reads rows of unit column stride
        r = encode_bias(fn, &tb, bias, bias_st, batch, n, heads, type);
    }
    if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(r);
    const long long* bs = bias_st;
    const Params<T> p{static_cast<T*>(o), o_st[0], o_st[1], o_st[2], static_cast<const T*>(bias),
                      bias ? bs[0] : 0, bias ? bs[1] : 0, bias ? bs[2] : 0, bias ? bs[3] : 0, n, fill, qk_scale_log2};
    return bias == nullptr ? launch<T, BIAS_NONE>(tq, tk, tv, tb, p, batch, heads, stream)
                           : launch<T, BIAS_ELEM>(tq, tk, tv, tb, p, batch, heads, stream);
}

}  // namespace

// Launch the kernel on the current device. `half`: q, k, v, out and the
// bias are float16 (else bfloat16). Pointers and (batch, row, head)
// element strides as flash_attention.cu's Args carries them; the caller has
// checked 16-byte alignment of q, k, v and out. `bias`: null, or the bias's
// element (0, 0, 0, 0) (a stack layer's offset applied) with `bias_st` its
// (batch, head, row, column) element strides and `fill` FILL_TMA or
// FILL_COPY. Returns the error of a tensor-map encode (a CUresult, whose
// codes agree with cudaError_t's for invalid values) or of the launch.
cudaError_t flash_attention_sm90(bool half, const void* q, const long long* q_st, const void* k, const long long* k_st,
                                 const void* v, const long long* v_st, void* o, const long long* o_st, const void* bias,
                                 const long long* bias_st, int fill, int batch, int n, int heads, float qk_scale_log2,
                                 cudaStream_t stream) {
    return half ? launch_elem<__half>(q, q_st, k, k_st, v, v_st, o, o_st, bias, bias_st, fill, batch, n, heads, qk_scale_log2,
                                      stream)
                : launch_elem<__nv_bfloat16>(q, q_st, k, k_st, v, v_st, o, o_st, bias, bias_st, fill, batch, n, heads,
                                             qk_scale_log2, stream);
}

// An instantiation's resources, for a report: `bias` 0 (unbiased) or 1 (a
// bias of the element type), `half` 0 (bfloat16) or 1 (float16); out:
// registers per thread at launch (before setmaxnreg), local memory (spill)
// bytes per thread, static and dynamic shared memory bytes, threads per
// block. Returns the cudaError_t.
extern "C" int mdpt_flash_attention_sm90_info(int bias, int half, int* out) {
    cudaFuncAttributes at;
    const void* kernel = half ? (bias ? (const void*)fa_sm90<__half, BIAS_ELEM> : (const void*)fa_sm90<__half, BIAS_NONE>)
                              : (bias ? (const void*)fa_sm90<__nv_bfloat16, BIAS_ELEM> : (const void*)fa_sm90<__nv_bfloat16, BIAS_NONE>);
    const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)at.sharedSizeBytes;
    out[3] = bias ? SMEM_BYTES<__nv_bfloat16, BIAS_ELEM> : SMEM_BYTES<__nv_bfloat16, BIAS_NONE>;  // the same for __half
    out[4] = at.maxThreadsPerBlock;
    return 0;
}
