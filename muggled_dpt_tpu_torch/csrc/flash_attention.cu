// Flash attention for Hopper (sm_90a), float32 and bfloat16, on strided q, k
// and v with an optional additive bias.
//
// Replaces four TPU kernels of muggled_dpt_tpu/ops/pallas/flash_attention.py,
// which compute the same math on differently laid-out inputs:
//   #1 flash_attention_fused_qkv, unbiased       -> _onepass_qkv_kernel (:125)
//   #2 the same, biased: a bias tensor (:472-478) or bias_stack + layer (:434-464)
//   #4 flash_attention (B, N, H, D), one-pass     -> _onepass_kernel (:86)
//   #5 the same past 32768 keys (online)          -> _online_kernel (:497)
// Per batch b and head h it computes
//   out[b, i, h, :] = sum_j softmax_j(q_i . k_j * scale + bias[b, h, i, j]) v_j
// where q, k, v and out are addressed by (batch, row, head) strides in
// elements and the head dim (D = 64) is contiguous. The fused-qkv call passes
// q = qkv, k = qkv + D, v = qkv + 2D with row stride 3C and head stride 3D,
// so q, k and v are read in place from the projection output. The bias is
// addressed by (batch, head, row, column) strides plus a base offset: a batch
// stride of 0 broadcasts one (1, H, N, N) bias over the batch, a zero row or
// column stride broadcasts a (.., 1, N) or (.., N, 1) bias, and the offset
// selects one layer of a cached (L, H, Np, Np) stack without a copy.
//
// Design: one CTA per (q tile of 64 rows, head, batch), FlashAttention-2
// style. K/V tiles stream through shared memory at every N; each q row keeps
// a running (max m, sum l, accumulator acc) in registers. That one streaming
// loop replaces the TPU's one-pass/online split, its whole-row VMEM residency,
// its head grouping (hpp) and its bias downcast, which were TPU tactics.
// The bias is read straight from global memory into registers, in the layout
// of the logits it is added to, one key tile ahead: tile t+1's loads are
// issued at the top of tile t, so a whole tile of work hides their latency
// (loading each tile's bias just before its use left the biased kernel 2.3x
// slower at BEiT-L-512's shape). No shared-memory stage, so any stride is
// legal; an even row stride with unit column stride gets its own
// instantiation with 2-element loads at immediate offsets (134 registers
// against 237 for one kernel that branched between the two load forms),
// which is why the BEiT encoder pads its bias rows to a multiple of 8.
// Numerics kept from the TPU kernels:
//   * exp2 domain: logits are s * scale * log2(e) + bias * log2(e), in f32,
//     equal to the natural-exp softmax of s * scale + bias. The f32 kernel
//     folds scale * log2(e) into q; the bf16 kernel applies it to the f32
//     logits, so q is not rounded to bf16 a second time;
//   * keys at or past N are replaced by NEG_INF, whatever the bias holds
//     there (never an analytic pad-count correction, which fails when every
//     logit is very negative);
//   * logits, softmax and accumulation in f32; p is rounded to the input
//     type before the PV product; out = acc / max(l, 1e-30);
//   * q rows past N are computed on zero input and never written.
//
// Bounds on an H100: at N=1025, D=64, 16 heads one call does about
// 2 * 2 * N^2 * D * H = 4.3 GFLOP per image against 3 * N * C * 2 B = 6.3 MB
// of bf16 qkv and, with a bias, H * N^2 * 2 B = 34 MB of bf16 bias: compute
// bound without a bias, near the ridge with one. The bf16 kernel runs both
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 out),
// with K/V double-buffered by cp.async and the bias fetched a tile ahead;
// the f32 kernel (the parity mode) uses plain FMAs, since TF32 tensor cores
// would not hold float32 accuracy.
// Left for later: wgmma and TMA with a warp-specialised producer, keeping P
// in registers across a 64-row warpgroup tile, and a persistent grid.
// The mma.sync, cp.async and ldmatrix helpers live in flash_tile.cuh, which
// the measurement variants (#10-#12) share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tile.cuh"

namespace {

// bias element types: template argument BIAS
constexpr int BIAS_NONE = 0, BIAS_F32 = 1, BIAS_BF16 = 2;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    const void* bias;
    long long q_sb, q_sn, q_sh;  // element strides: batch, row, head
    long long k_sb, k_sn, k_sh;
    long long v_sb, v_sn, v_sh;
    long long o_sb, o_sn, o_sh;
    long long b_off, b_sb, b_sh, b_sn, b_sk;  // bias: base offset, batch, head, row, column
    int n;
    float qk_scale_log2;
};

template <int BIAS>
__device__ __forceinline__ float bias_load(const void* p, long long idx) {
    if constexpr (BIAS == BIAS_F32) {
        return __ldg(static_cast<const float*>(p) + idx);
    } else {
        return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
    }
}

// ---------------------------------------------------------------------------
// float32: SIMT kernel, one thread per q row
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;  // q rows per CTA == threads per CTA
constexpr int F32_BK = 32;  // keys per shared-memory tile

template <int BIAS>
__global__ void __launch_bounds__(F32_BQ) fa_f32(const Args a) {
    __shared__ float4 ks[F32_BK][D / 4];
    __shared__ float4 vs[F32_BK][D / 4];

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x;
    const int n = a.n;
    const int qi = blockIdx.x * F32_BQ + tid;
    const int qrow = min(qi, n - 1);
    const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    // this thread copies rows r0 + 4j (j = 0..7) of each tile, float4 column c4
    const int r0 = tid / (D / 4), c4 = tid % (D / 4);
    const float4* kt = reinterpret_cast<const float4*>(static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh + r0 * a.k_sn) + c4;
    const float4* vt = reinterpret_cast<const float4*>(static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh + r0 * a.v_sn) + c4;
    const long long k4 = a.k_sn, v4 = a.v_sn;  // 4 rows, in float4 units
    const long long brow = a.b_off + b * a.b_sb + h * a.b_sh + qrow * a.b_sn;

    float4 q[D / 4];
    const float4* qp = reinterpret_cast<const float4*>(qb + qrow * a.q_sn);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
        const float4 t = qp[i];
        const float sc = a.qk_scale_log2;
        q[i] = make_float4(t.x * sc, t.y * sc, t.z * sc, t.w * sc);
    }

    float4 acc[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = NEG_INF, l = 0.f;

    for (int k0 = 0; k0 < n; k0 += F32_BK) {
        __syncthreads();  // the previous tile has been consumed
#pragma unroll
        for (int j = 0; j < F32_BK / 4; ++j) {
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (k0 + r0 + 4 * j < n) {
                kv = kt[j * k4];
                vv = vt[j * v4];
            }
            ks[r0 + 4 * j][c4] = kv;
            vs[r0 + 4 * j][c4] = vv;
        }
        kt += F32_BK / 4 * k4;
        vt += F32_BK / 4 * v4;
        __syncthreads();

        // logits start from the bias (exp2 domain) so it costs no registers
        float s[F32_BK];
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) {
            s[j] = 0.f;
            if constexpr (BIAS != BIAS_NONE) {
                if (k0 + j < n) s[j] = bias_load<BIAS>(a.bias, brow + (k0 + j) * a.b_sk) * LOG2E;
            }
        }
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
#pragma unroll
            for (int j = 0; j < F32_BK; ++j) {
                const float4 kv = ks[j][i];
                s[j] = fmaf(q[i].x, kv.x, s[j]);
                s[j] = fmaf(q[i].y, kv.y, s[j]);
                s[j] = fmaf(q[i].z, kv.z, s[j]);
                s[j] = fmaf(q[i].w, kv.w, s[j]);
            }
        }
        float m_new = m;
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) {
            if (k0 + j >= n) s[j] = NEG_INF;
            m_new = fmaxf(m_new, s[j]);
        }
        const float alpha = exp2f(m - m_new);
        m = m_new;
        l *= alpha;
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
            acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
        }
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) {
            const float p = exp2f(s[j] - m);
            l += p;
#pragma unroll
            for (int i = 0; i < D / 4; ++i) {
                const float4 vv = vs[j][i];
                acc[i].x = fmaf(p, vv.x, acc[i].x);
                acc[i].y = fmaf(p, vv.y, acc[i].y);
                acc[i].z = fmaf(p, vv.z, acc[i].z);
                acc[i].w = fmaf(p, vv.w, acc[i].w);
            }
        }
    }

    if (qi < n) {
        const float lr = fmaxf(l, 1e-30f);
        float4* op = reinterpret_cast<float4*>(static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh + qi * a.o_sn);
#pragma unroll
        for (int i = 0; i < D / 4; ++i)
            op[i] = make_float4(acc[i].x / lr, acc[i].y / lr, acc[i].z / lr, acc[i].w / lr);
    }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel, 4 warps x 16 q rows, mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // q rows per CTA (16 per warp)
constexpr int THREADS = 128;

// Copy 64 rows x 64 columns of one head's q, k or v into shared memory: 512
// chunks of 16 B, 4 per thread. This thread copies rows r0 + 16i (i = 0..3)
// at column c0: p points at row r0 of the tile, at column c0; `first` is
// the tile's first row; `fallback` is a valid address for rows past N.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[LDS], const __nv_bfloat16* p, long long step16, int first,
                                          int n, int r0, int c0, const __nv_bfloat16* fallback) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool valid = first + r0 + 16 * i < n;
        cp_async16(&dst[r0 + 16 * i][c0], valid ? p + i * step16 : fallback, valid);
    }
}

// Raw bias of one fragment element pair: packed bf16x2, or float2 for a
// float32 bias. Fetched a tile ahead, unpacked where it is added.
template <int BIAS>
using BiasRaw = typename std::conditional<BIAS == BIAS_F32, float2, uint32_t>::type;

template <int BIAS>
__device__ __forceinline__ float2 bias_unpack(BiasRaw<BIAS> v) {
    if constexpr (BIAS == BIAS_F32) {
        return v;
    } else {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    }
}

// This thread's bias for the 64-key tile at kbase, in the S C-fragment
// layout: rows g and g + 8 (row pointers row_g, row_g8; null past N),
// columns 2cq and 2cq + 1 of each 8-key tile nt; 0 past N.
template <int BIAS, bool PAIRS>
__device__ __forceinline__ void bias_fetch(BiasRaw<BIAS> (&raw)[2][BK / 8], const Args& a, const void* row_g,
                                           const void* row_g8, int kbase, int n, int cq) {
    using T = typename std::conditional<BIAS == BIAS_F32, float, unsigned short>::type;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const T* row = static_cast<const T*>(r == 0 ? row_g : row_g8);
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
            const int key = kbase + nt * 8 + 2 * cq;
            BiasRaw<BIAS> v{};
            if (row != nullptr) {
                if constexpr (PAIRS) {  // column stride 1: immediate offsets off the row pointer
                    if (key + 1 < n) {
                        v = *reinterpret_cast<const BiasRaw<BIAS>*>(row + key);
                    } else if (key < n) {
                        if constexpr (BIAS == BIAS_F32) v.x = row[key]; else v = row[key];
                    }
                } else if constexpr (BIAS == BIAS_F32) {
                    if (key < n) v.x = row[key * a.b_sk];
                    if (key + 1 < n) v.y = row[(key + 1) * a.b_sk];
                } else {
                    if (key < n) v = row[key * a.b_sk];
                    if (key + 1 < n) v |= (uint32_t)row[(key + 1) * a.b_sk] << 16;
                }
            }
            raw[r][nt] = v;
        }
    }
}

template <int BIAS, bool PAIRS>
__global__ void __launch_bounds__(THREADS) fa_bf16(const Args a) {
    __shared__ __align__(16) __nv_bfloat16 qs[BQ][LDS];
    __shared__ __align__(16) __nv_bfloat16 ks[2][BK][LDS];
    __shared__ __align__(16) __nv_bfloat16 vs[2][BK][LDS];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;  // fragment row group and column pair
    const int n = a.n;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
    // this thread's share of every tile copy: rows r0 + 16i, 16-byte column chunk c0
    const int r0 = tid / (D / 8), c0 = (tid % (D / 8)) * 8;
    const __nv_bfloat16* kt = kb + r0 * a.k_sn + c0;  // advanced by one tile per iteration
    const __nv_bfloat16* vt = vb + r0 * a.v_sn + c0;
    const long long k16 = 16 * a.k_sn, v16 = 16 * a.v_sn;
    // this thread's logit rows are row_g and row_g + 8
    const int row_g = q0 + warp * 16 + g;

    load_tile(qs, qb + (q0 + r0) * a.q_sn + c0, 16 * a.q_sn, q0, n, r0, c0, qb);
    load_tile(ks[0], kt, k16, 0, n, r0, c0, kb);
    load_tile(vs[0], vt, v16, 0, n, r0, c0, vb);
    cp_async_commit();

    uint32_t qf[D / 16][4];  // this warp's Q A-fragments, one per 16-wide k step
    float acc[D / 8][4];     // O C-fragments, one per 8-wide column tile
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp's 16
    float l_r[2] = {0.f, 0.f};          // per-thread partial sums, reduced at the end

    // The bias is fetched one tile ahead into registers, so its loads are in
    // flight through a whole tile of work.
    const void* bias_g = nullptr;   // bias row of logit row row_g
    const void* bias_g8 = nullptr;  // and of row_g + 8
    BiasRaw<BIAS> bias_next[2][BK / 8];
    if constexpr (BIAS != BIAS_NONE) {
        using T = typename std::conditional<BIAS == BIAS_F32, float, __nv_bfloat16>::type;
        const T* head = static_cast<const T*>(a.bias) + a.b_off + b * a.b_sb + h * a.b_sh;
        if (row_g < n) bias_g = head + row_g * a.b_sn;
        if (row_g + 8 < n) bias_g8 = head + (row_g + 8) * a.b_sn;
        bias_fetch<BIAS, PAIRS>(bias_next, a, bias_g, bias_g8, 0, n, cq);
    }

    const int num_tiles = (n + BK - 1) / BK;
    for (int t = 0; t < num_tiles; ++t) {
        const int st = t & 1;
        if (t + 1 < num_tiles) {
            kt += BK * a.k_sn;
            vt += BK * a.v_sn;
            load_tile(ks[st ^ 1], kt, k16, (t + 1) * BK, n, r0, c0, kb);
            load_tile(vs[st ^ 1], vt, v16, (t + 1) * BK, n, r0, c0, vb);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        if (t == 0) {
            const int rq = warp * 16 + g;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                qf[kk][0] = ld_u32(&qs[rq][kk * 16 + 2 * cq]);
                qf[kk][1] = ld_u32(&qs[rq + 8][kk * 16 + 2 * cq]);
                qf[kk][2] = ld_u32(&qs[rq][kk * 16 + 2 * cq + 8]);
                qf[kk][3] = ld_u32(&qs[rq + 8][kk * 16 + 2 * cq + 8]);
            }
        }

        BiasRaw<BIAS> bias_cur[2][BK / 8];
        if constexpr (BIAS != BIAS_NONE) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int nt = 0; nt < BK / 8; ++nt) bias_cur[r][nt] = bias_next[r][nt];
            if (t + 1 < num_tiles) bias_fetch<BIAS, PAIRS>(bias_next, a, bias_g, bias_g8, (t + 1) * BK, n, cq);
        }

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
                const __nv_bfloat16* kp = &ks[st][nt * 8 + g][kk * 16 + 2 * cq];
                mma_16816(s[nt], qf[kk], ld_u32(kp), ld_u32(kp + 8));
            }
        }

        // exp2-domain logits (+ bias), tail keys replaced, running row max
        const int kbase = t * BK;
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kbase + nt * 8 + 2 * cq + (e & 1);
                float v = s[nt][e] * a.qk_scale_log2;
                if constexpr (BIAS != BIAS_NONE) {
                    const float2 bp = bias_unpack<BIAS>(bias_cur[e >> 1][nt]);
                    v = fmaf(s[nt][e], a.qk_scale_log2, ((e & 1) ? bp.y : bp.x) * LOG2E);
                }
                v = key < n ? v : NEG_INF;
                s[nt][e] = v;
                mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = exp2f(m_r[r] - mx[r]);
            m_r[r] = mx[r];
            l_r[r] *= alpha[r];
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            acc[dt][0] *= alpha[0];
            acc[dt][1] *= alpha[0];
            acc[dt][2] *= alpha[1];
            acc[dt][3] *= alpha[1];
        }

        // P = exp2(S - m), rounded to bf16; the S C-fragments of key tiles
        // 2j and 2j+1 are exactly the A-fragment of PV k step j
        uint32_t pf[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const float* sv = s[2 * j + half];
                const float p0 = exp2f(sv[0] - m_r[0]), p1 = exp2f(sv[1] - m_r[0]);
                const float p2 = exp2f(sv[2] - m_r[1]), p3 = exp2f(sv[3] - m_r[1]);
                l_r[0] += p0 + p1;
                l_r[1] += p2 + p3;
                pf[j][2 * half] = pack_bf16(p0, p1);
                pf[j][2 * half + 1] = pack_bf16(p2, p3);
            }
        }

        // O += P V; V B-fragments come transposed out of shared memory
        const int mtx = lane / 8, mrow = lane % 8;
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t vfrag[4];
                ldmatrix_x4_trans(vfrag, &vs[st][j * 16 + (mtx & 1) * 8 + mrow][dp * 16 + (mtx >> 1) * 8]);
                mma_16816(acc[2 * dp], pf[j], vfrag[0], vfrag[1]);
                mma_16816(acc[2 * dp + 1], pf[j], vfrag[2], vfrag[3]);
            }
        }
        __syncthreads();  // this stage is refilled two iterations on
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        if (row < n) {
            const float lr = fmaxf(l_r[r], 1e-30f);
            __nv_bfloat16* op = ob + row * a.o_sn;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt)
                *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * cq) = pack_bf16(acc[dt][2 * r] / lr, acc[dt][2 * r + 1] / lr);
        }
    }
}

// pairs: the bias has column stride 1 and every bias row starts at an even
// element, so the bf16 kernel loads bias pairs at immediate offsets
template <int BIAS>
cudaError_t launch(const Args& a, int dtype, bool pairs, dim3 grid, cudaStream_t s) {
    if (dtype == 0) {
        fa_f32<BIAS><<<grid, F32_BQ, 0, s>>>(a);
    } else if constexpr (BIAS == BIAS_NONE) {
        fa_bf16<BIAS, false><<<grid, THREADS, 0, s>>>(a);
    } else if (pairs) {
        fa_bf16<BIAS, true><<<grid, THREADS, 0, s>>>(a);
    } else {
        fa_bf16<BIAS, false><<<grid, THREADS, 0, s>>>(a);
    }
    return cudaGetLastError();
}

cudaError_t launch_any(const Args& a, int dtype, int bias_dtype, int batch, int num_heads, cudaStream_t s) {
    bool pairs = false;
    if (bias_dtype >= 0) {
        const long long esize = bias_dtype == 0 ? 4 : 2;
        const uintptr_t first = reinterpret_cast<uintptr_t>(a.bias) + (uintptr_t)(a.b_off * esize);
        pairs = a.b_sk == 1 && first % (2 * esize) == 0 && a.b_sb % 2 == 0 && a.b_sh % 2 == 0 && a.b_sn % 2 == 0;
    }
    const dim3 grid((a.n + BQ - 1) / BQ, num_heads, batch);
    if (bias_dtype == -1) return launch<BIAS_NONE>(a, dtype, pairs, grid, s);
    if (bias_dtype == 0) return launch<BIAS_F32>(a, dtype, pairs, grid, s);
    return launch<BIAS_BF16>(a, dtype, pairs, grid, s);
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_Q = 0,        // q: address, then batch, row and head strides
    SLOT_K = 4,        // k: the same
    SLOT_V = 8,        // v: the same
    SLOT_O = 12,       // out: the same
    SLOT_BIAS = 16,    // bias: address, element offset, then batch, head, row and column strides
    SLOT_BATCH = 22,
    SLOT_N,
    SLOT_HEADS,
    SLOT_HEAD_DIM,
    SLOT_DTYPE,        // q, k, v and out: 0 = float32, 1 = bfloat16
    SLOT_BIAS_DTYPE,   // -1 = no bias, 0 = float32, 1 = bfloat16
    SLOT_DEVICE,       // the CUDA device of every tensor
    NUM_SLOTS,
};

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot`, so a launch crosses from Python in three arguments.
// Strides and the bias offset are in elements; the head dim is contiguous in
// q, k, v and out. The caller checks alignment (16 B for q, k, v and out
// rows). The launch goes to args[SLOT_DEVICE]; the calling thread's current
// device is the same after the call as before. Returns the cudaError_t of the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int mdpt_flash_attention(const long long* args, float qk_scale_log2, void* stream) {
    const int batch = (int)args[SLOT_BATCH], n = (int)args[SLOT_N], num_heads = (int)args[SLOT_HEADS];
    const int dtype = (int)args[SLOT_DTYPE], bias_dtype = (int)args[SLOT_BIAS_DTYPE], device = (int)args[SLOT_DEVICE];
    const void* bias = reinterpret_cast<const void*>(args[SLOT_BIAS]);
    if (args[SLOT_HEAD_DIM] != D || n < 1 || batch < 1 || num_heads < 1 || batch > 65535 || num_heads > 65535)
        return (int)cudaErrorInvalidValue;
    if ((dtype != 0 && dtype != 1) || bias_dtype < -1 || bias_dtype > 1 || (bias_dtype >= 0 && bias == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long* q = args + SLOT_Q;
    const long long* k = args + SLOT_K;
    const long long* v = args + SLOT_V;
    const long long* o = args + SLOT_O;
    const long long* bs = args + SLOT_BIAS + 2;
    const Args a{reinterpret_cast<const void*>(q[0]), reinterpret_cast<const void*>(k[0]),
                 reinterpret_cast<const void*>(v[0]), reinterpret_cast<void*>(o[0]), bias,
                 q[1], q[2], q[3], k[1], k[2], k[3], v[1], v[2], v[3], o[1], o[2], o[3],
                 args[SLOT_BIAS + 1], bs[0], bs[1], bs[2], bs[3], n, qk_scale_log2};
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = launch_any(a, dtype, bias_dtype, batch, num_heads, static_cast<cudaStream_t>(stream));
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
