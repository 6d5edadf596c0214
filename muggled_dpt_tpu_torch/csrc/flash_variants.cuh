// Measurement variants of flash attention #1 for Hopper (sm_90a): one kernel
// template per dtype over #1's streaming key-tile loop, the variant chosen by
// template parameters. Three sources instantiate it, each its own nvcc job:
//   #10 flash_attention_xl.cu     <- experiments/flash_attention_xl.py:_xl_qkv_kernel (:69)
//   #11 flash_attention_staged.cu <- experiments/flash_attention_staged.py:_staged_qkv_kernel (:74)
//   #12 flash_variant.cu          <- tools/attn_variants.py:_onepass_kernel (:77), _innerloop_kernel (:110)
// No model serves through them, as in the JAX package: they are the
// attention sweep's variants (muggled_dpt_tpu_torch/tools/flash_tune.py).
//
// Per batch b and head h, over q rows i < n and the keys j < kend:
//   s[i, j] = (q_i . k_j) * qk_scale; keys at or past kend are excluded
//   (logit -1e30, weight 0); k and v rows at or past n read as zeros, so
//   keys in [n, kend) are the zero pad keys of #12's padded inputs.
// Modes (template MODE):
//   MODE_FLASH      #10: #1's math: online softmax in the exp2 domain, the
//                   row sum of the f32 weights, out = acc / max(l, 1e-30);
//   MODE_ABLATE     #10 ablate_softmax: p = s * 1e-6 cast to v's dtype,
//                   out = p v; no max, sum or division (a timing floor);
//   MODE_STAGED     #11: two passes with no online rescaling. Pass 1
//                   streams K only and keeps the row max, panel by panel:
//                   each key panel reduces its own max (quad shuffles at
//                   the panel's end) and the row max is the maximum of the
//                   panels'. Pass 2 recomputes QK^T, streams K and V, and
//                   takes p = exp2(s - m), PV and the row sum. The panels run
//                   in sequence in one CTA (no split-K grid): a 64-row f32
//                   logit block at N=18497 is 4.7 MB, so it is recomputed,
//                   never kept. Max is exact, so the output does not depend
//                   on the panels at all;
//   MODE_MASK_EXP   #12 mask_exp: online softmax in natural exp (q pre-scaled);
//   MODE_MASK_EXP2  #12 mask_exp2: the same in exp2;
//   MODE_PADFIX     #12 padfix and chunk: online softmax over the zero pad
//                   keys too (their logit 0 counts in the max); at each chunk
//                   end the chunk's pad keys' weight, pads * 2^-m, is
//                   subtracted from l (padfix: one chunk of all kend keys).
//                   Exact in the running-max units, so it is the JAX
//                   correction; it cancels catastrophically when every real
//                   logit is far below 0, as the JAX kernels do;
//   MODE_NOSM       #12 nosm: p = s, l = 1;
//   MODE_MAXONLY    #12 maxonly: pass 1 the row max over real and pad keys,
//                   pass 2 p = s - m, l = 1;
//   MODE_EXPONLY    #12 exponly: p = exp2(s), l = 1.
// bf16 (fv_bf16): 4 warps of 16 q rows per 64-row q block, QP q blocks per
// CTA (#10's qp: 128 * QP threads sharing each K/V tile in shared memory);
// both products on mma.sync m16n8k16; the Q fragments are read once from
// global memory into registers. PIPELINED (#10): K runs one tile ahead of V
// (two rings of two stages, 36 KB of static shared memory), so each
// iteration issues key tile t+1's QK^T mma.sync before tile t's softmax and
// PV: the FA3 intra-warpgroup overlap on synchronous MMAs, where the
// scheduler interleaves the independent tensor-core and exp2 work. p is
// rounded to bf16 before PV; logits, softmax and sums stay f32.
// f32 (fv_f32): #1's FMA kernel, one thread per q row, QP * 64 threads per
// CTA sharing 32-key tiles; pipelining has no meaning there and is ignored.
//
// Bounds on an H100: 4 B H N^2 D operations (QK^T and PV) against 4 B N H D
// bf16 elements moved: at N=18497, 16 heads, one call is 1.40 TFLOP,
// 1.417 ms at the dense bf16 peak, compute bound by far (#11's recompute
// pass is the implementation's, not the function's). The kernels run on
// mma.sync, not wgmma: they are for measuring the variants against #1 on the
// same tile code, not for peak.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

enum Mode {
    MODE_FLASH = 0,
    MODE_ABLATE = 1,
    MODE_STAGED = 2,
    MODE_MASK_EXP = 3,
    MODE_MASK_EXP2 = 4,
    MODE_PADFIX = 5,
    MODE_NOSM = 6,
    MODE_MAXONLY = 7,
    MODE_EXPONLY = 8,
};

constexpr int SM_ONLINE = 0, SM_TWO_PASS = 1, SM_NONE = 2;

__host__ __device__ constexpr int softmax_of(int mode) {
    return (mode == MODE_STAGED || mode == MODE_MAXONLY)                         ? SM_TWO_PASS
           : (mode == MODE_ABLATE || mode == MODE_NOSM || mode == MODE_EXPONLY) ? SM_NONE
                                                                                  : SM_ONLINE;
}

struct VArgs {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long q_sb, q_sn, q_sh;  // element strides: batch, row, head
    long long k_sb, k_sn, k_sh;
    long long v_sb, v_sn, v_sh;
    long long o_sb, o_sn, o_sh;
    int n;      // q rows and real keys: k and v rows at or past n read as zeros
    int kend;   // keys taken: those at or past kend are excluded
    int panel;  // two-pass modes: keys per panel, a multiple of BK (the last takes the remainder)
    int chunk;  // MODE_PADFIX: keys per chunk
    float qk_scale;
};

template <int MODE>
__device__ __forceinline__ float expf_mode(float x) {
    if constexpr (MODE == MODE_MASK_EXP) {
        return expf(x);
    } else {
        return exp2f(x);
    }
}

// Pad keys of the chunk that ends at key e (JAX _innerloop_kernel:126-127).
__device__ __forceinline__ int chunk_pads(int e, int chunk, int n) { return e > n ? e - max(n, e - chunk) : 0; }

// p of a mode without a softmax, for a key inside [0, kend) (0 outside).
template <int MODE>
__device__ __forceinline__ float plain_weight(float s) {
    if constexpr (MODE == MODE_ABLATE) {
        return s * 1e-6f;
    } else if constexpr (MODE == MODE_NOSM) {
        return s;
    } else {
        return exp2f(s);
    }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

// This warp's Q A-fragments straight from global memory: rows row and
// row + 8, columns 2cq, 2cq + 1 (+8) of each 16-wide k step; 0 past n.
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4], const __nv_bfloat16* qb, long long sn, int row,
                                             int n, int cq) {
    const __nv_bfloat16* r0 = qb + row * sn + 2 * cq;
    const __nv_bfloat16* r8 = qb + (row + 8) * sn + 2 * cq;
    const bool v0 = row < n, v8 = row + 8 < n;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = v0 ? ld_u32(r0 + kk * 16) : 0u;
        qf[kk][1] = v8 ? ld_u32(r8 + kk * 16) : 0u;
        qf[kk][2] = v0 ? ld_u32(r0 + kk * 16 + 8) : 0u;
        qf[kk][3] = v8 ? ld_u32(r8 + kk * 16 + 8) : 0u;
    }
}

// Copy key rows [first, first + 64) of one head's k or v into shared memory:
// 512 chunks of 16 B over THREADS threads; rows at or past n zero-filled.
template <int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*dst)[LDS], const __nv_bfloat16* base, long long sn, int first,
                                          int n, int tid) {
#pragma unroll
    for (int i = 0; i < BK * (D / 8) / THREADS; ++i) {
        const int c = tid + i * THREADS, r = c / (D / 8), col = (c % (D / 8)) * 8;
        const bool valid = first + r < n;
        cp_async16(&dst[r][col], valid ? base + (first + r) * sn + col : base, valid);
    }
}

// S = Q K^T for this warp's 16 rows and the 64 keys in ks, scaled, with
// keys at or past kend set to NEG_INF.
__device__ __forceinline__ void tile_logits(float (&s)[BK / 8][4], const uint32_t (&qf)[D / 16][4],
                                            const __nv_bfloat16 (*ks)[LDS], int kbase, int kend, float qk_scale,
                                            int g, int cq) {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
            const __nv_bfloat16* kp = &ks[nt * 8 + g][kk * 16 + 2 * cq];
            mma_16816(s[nt], qf[kk], ld_u32(kp), ld_u32(kp + 8));
        }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = kbase + nt * 8 + 2 * cq + (e & 1);
            s[nt][e] = key < kend ? s[nt][e] * qk_scale : NEG_INF;
        }
    }
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ void tile_rowmax(float (&mx)[2], const float (&s)[BK / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
}

// O += P V; V B-fragments come transposed out of shared memory
__device__ __forceinline__ void tile_pv(float (&acc)[D / 8][4], const uint32_t (&pf)[BK / 16][4],
                                        const __nv_bfloat16 (*vs)[LDS], int lane) {
    const int mtx = lane / 8, mrow = lane % 8;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t vfrag[4];
            ldmatrix_x4_trans(vfrag, &vs[j * 16 + (mtx & 1) * 8 + mrow][dp * 16 + (mtx >> 1) * 8]);
            mma_16816(acc[2 * dp], pf[j], vfrag[0], vfrag[1]);
            mma_16816(acc[2 * dp + 1], pf[j], vfrag[2], vfrag[3]);
        }
    }
}

// Running row statistics of this thread's two rows (g and g + 8).
struct RowState {
    float m[2];    // running max (quad-uniform)
    float l[2];    // this thread's partial row sums, reduced over the quad at the end
    float pad[2];  // MODE_PADFIX: pad keys' weight to subtract from l (quad-uniform)
};

// One key tile's weights into bf16 A-fragments (the S C-fragments of key
// tiles 2j and 2j+1 are exactly the A-fragment of PV k step j), with the
// online rescale of acc and the row state first where MODE has one.
template <int MODE>
__device__ __forceinline__ void tile_weights(uint32_t (&pf)[BK / 16][4], const float (&s)[BK / 8][4],
                                             float (&acc)[D / 8][4], RowState& st, const VArgs& a, int kbase,
                                             int cq) {
    constexpr int SM = softmax_of(MODE);
    if constexpr (SM == SM_ONLINE) {
        float mx[2] = {st.m[0], st.m[1]};
        tile_rowmax(mx, s);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = quad_max(mx[r]);
            alpha[r] = expf_mode<MODE>(st.m[r] - mx[r]);
            st.m[r] = mx[r];
            st.l[r] *= alpha[r];
            st.pad[r] *= alpha[r];
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            acc[dt][0] *= alpha[0];
            acc[dt][1] *= alpha[0];
            acc[dt][2] *= alpha[1];
            acc[dt][3] *= alpha[1];
        }
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int nt = 2 * j + half;
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float m = st.m[e >> 1];
                if constexpr (SM == SM_ONLINE || MODE == MODE_STAGED) {
                    p[e] = expf_mode<MODE>(s[nt][e] - m);  // excluded keys: exp(-1e30 - m) = 0
                    st.l[e >> 1] += p[e];
                } else {
                    const bool in = kbase + nt * 8 + 2 * cq + (e & 1) < a.kend;
                    if constexpr (MODE == MODE_MAXONLY) {
                        p[e] = in ? s[nt][e] - m : 0.f;
                    } else {
                        p[e] = in ? plain_weight<MODE>(s[nt][e]) : 0.f;
                    }
                }
            }
            pf[j][2 * half] = pack_bf16(p[0], p[1]);
            pf[j][2 * half + 1] = pack_bf16(p[2], p[3]);
        }
    }
    if constexpr (MODE == MODE_PADFIX) {
        const int hi = min(kbase + BK, a.kend);
        for (int e = (kbase / a.chunk + 1) * a.chunk; e <= hi; e += a.chunk) {
            const int pads = chunk_pads(e, a.chunk, a.n);
            if (pads > 0) {
                st.pad[0] += (float)pads * exp2f(-st.m[0]);
                st.pad[1] += (float)pads * exp2f(-st.m[1]);
            }
        }
    }
}

template <int QP, bool PIPELINED, int MODE>
__global__ void __launch_bounds__(128 * QP) fv_bf16(const VArgs a) {
    constexpr int THREADS = 128 * QP;
    constexpr int SM = softmax_of(MODE);
    static_assert(!(PIPELINED && SM == SM_TWO_PASS), "the two-pass modes are not pipelined");
    __shared__ __align__(16) __nv_bfloat16 ks[2][BK][LDS];
    __shared__ __align__(16) __nv_bfloat16 vs[2][BK][LDS];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * (64 * QP);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;  // fragment row group and column pair
    const int n = a.n, kend = a.kend;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
    const int row_g = q0 + warp * 16 + g;  // this thread's logit rows: row_g and row_g + 8

    uint32_t qf[D / 16][4];
    load_q_frags(qf, qb, a.q_sn, row_g, n, cq);
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    RowState st{{NEG_INF, NEG_INF}, {0.f, 0.f}, {0.f, 0.f}};
    const int num_tiles = (kend + BK - 1) / BK;
    uint32_t pf[BK / 16][4];

    if constexpr (SM == SM_TWO_PASS) {
        // pass 1: K only, the row max panel by panel
        load_rows<THREADS>(ks[0], kb, a.k_sn, 0, n, tid);
        cp_async_commit();
        float mp[2] = {NEG_INF, NEG_INF};  // this panel's max, per thread
        for (int t = 0; t < num_tiles; ++t) {
            const int stg = t & 1;
            if (t + 1 < num_tiles) {
                load_rows<THREADS>(ks[stg ^ 1], kb, a.k_sn, (t + 1) * BK, n, tid);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            float s[BK / 8][4];
            tile_logits(s, qf, ks[stg], t * BK, kend, a.qk_scale, g, cq);
            tile_rowmax(mp, s);
            if ((t + 1) * BK % a.panel == 0 || t + 1 == num_tiles) {  // the panel's end: its max joins the row's
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    st.m[r] = fmaxf(st.m[r], quad_max(mp[r]));
                    mp[r] = NEG_INF;
                }
            }
            __syncthreads();  // this stage is refilled next iteration
        }
        // pass 2: K and V, p from the final max
        load_rows<THREADS>(ks[0], kb, a.k_sn, 0, n, tid);
        load_rows<THREADS>(vs[0], vb, a.v_sn, 0, n, tid);
        cp_async_commit();
        for (int t = 0; t < num_tiles; ++t) {
            const int stg = t & 1;
            if (t + 1 < num_tiles) {
                load_rows<THREADS>(ks[stg ^ 1], kb, a.k_sn, (t + 1) * BK, n, tid);
                load_rows<THREADS>(vs[stg ^ 1], vb, a.v_sn, (t + 1) * BK, n, tid);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            float s[BK / 8][4];
            tile_logits(s, qf, ks[stg], t * BK, kend, a.qk_scale, g, cq);
            tile_weights<MODE>(pf, s, acc, st, a, t * BK, cq);
            tile_pv(acc, pf, vs[stg], lane);
            __syncthreads();
        }
    } else if constexpr (PIPELINED) {
        // K one tile ahead of V: at the top of iteration t, K_{t+1} and V_t
        // are resident; K_{t+2} and V_{t+1} are issued into the slots that
        // iteration t-1 finished with.
        float s_cur[BK / 8][4], s_next[BK / 8][4];
        load_rows<THREADS>(ks[0], kb, a.k_sn, 0, n, tid);
        cp_async_commit();
        if (num_tiles > 1) load_rows<THREADS>(ks[1], kb, a.k_sn, BK, n, tid);
        load_rows<THREADS>(vs[0], vb, a.v_sn, 0, n, tid);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        tile_logits(s_cur, qf, ks[0], 0, kend, a.qk_scale, g, cq);
        for (int t = 0; t < num_tiles; ++t) {
            cp_async_wait<0>();
            __syncthreads();
            if (t + 2 < num_tiles) load_rows<THREADS>(ks[t & 1], kb, a.k_sn, (t + 2) * BK, n, tid);
            if (t + 1 < num_tiles) load_rows<THREADS>(vs[(t + 1) & 1], vb, a.v_sn, (t + 1) * BK, n, tid);
            cp_async_commit();
            if (t + 1 < num_tiles) tile_logits(s_next, qf, ks[(t + 1) & 1], (t + 1) * BK, kend, a.qk_scale, g, cq);
            tile_weights<MODE>(pf, s_cur, acc, st, a, t * BK, cq);
            tile_pv(acc, pf, vs[t & 1], lane);
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) s_cur[nt][e] = s_next[nt][e];
            }
        }
    } else {
        load_rows<THREADS>(ks[0], kb, a.k_sn, 0, n, tid);
        load_rows<THREADS>(vs[0], vb, a.v_sn, 0, n, tid);
        cp_async_commit();
        for (int t = 0; t < num_tiles; ++t) {
            cp_async_wait<0>();
            __syncthreads();  // tile t landed; every warp is done with tile t-1's stage
            if (t + 1 < num_tiles) {
                load_rows<THREADS>(ks[(t + 1) & 1], kb, a.k_sn, (t + 1) * BK, n, tid);
                load_rows<THREADS>(vs[(t + 1) & 1], vb, a.v_sn, (t + 1) * BK, n, tid);
            }
            cp_async_commit();
            float s[BK / 8][4];
            tile_logits(s, qf, ks[t & 1], t * BK, kend, a.qk_scale, g, cq);
            tile_weights<MODE>(pf, s, acc, st, a, t * BK, cq);
            tile_pv(acc, pf, vs[t & 1], lane);
        }
    }

    constexpr bool NORMALIZED = SM == SM_ONLINE || MODE == MODE_STAGED;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lr = 1.f;
        if constexpr (NORMALIZED) {
            float l = st.l[r];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            lr = fmaxf(l - st.pad[r], 1e-30f);
        }
        const int row = row_g + 8 * r;
        if (row < n) {
            __nv_bfloat16* op = ob + row * a.o_sn;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt)
                *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * cq) = pack_bf16(acc[dt][2 * r] / lr, acc[dt][2 * r + 1] / lr);
        }
    }
}

// ---------------------------------------------------------------------------
// float32: SIMT kernel, one thread per q row (#1's fa_f32 with the modes)
// ---------------------------------------------------------------------------

constexpr int F32_BK = 32;  // keys per shared-memory tile

// Copy key rows [first, first + 32) of k (and v) into shared memory; rows at
// or past n read as zeros.
template <int THREADS>
__device__ __forceinline__ void f32_load(float4 (*ks)[D / 4], float4 (*vs)[D / 4], const float* kb, long long k_sn,
                                         const float* vb, long long v_sn, int first, int n, int tid) {
#pragma unroll
    for (int i = 0; i < F32_BK * (D / 4) / THREADS; ++i) {
        const int c = tid + i * THREADS, r = c / (D / 4), c4 = c % (D / 4);
        const int row = first + r;
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (row < n) {
            kv = reinterpret_cast<const float4*>(kb + row * k_sn)[c4];
            if (vs != nullptr) vv = reinterpret_cast<const float4*>(vb + row * v_sn)[c4];
        }
        ks[r][c4] = kv;
        if (vs != nullptr) vs[r][c4] = vv;
    }
}

// This row's logits against the 32 keys in ks (q pre-scaled); keys at or
// past kend set to NEG_INF.
__device__ __forceinline__ void f32_logits(float (&s)[F32_BK], const float4 (&q)[D / 4], const float4 (*ks)[D / 4], int k0,
                                           int kend) {
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) s[j] = 0.f;
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
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) s[j] = k0 + j < kend ? s[j] : NEG_INF;
}

template <int QP, int MODE>
__global__ void __launch_bounds__(64 * QP) fv_f32(const VArgs a) {
    constexpr int THREADS = 64 * QP;
    constexpr int SM = softmax_of(MODE);
    __shared__ float4 ks[F32_BK][D / 4];
    __shared__ float4 vs[F32_BK][D / 4];

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x;
    const int n = a.n, kend = a.kend;
    const int qi = blockIdx.x * THREADS + tid;
    const int qrow = min(qi, n - 1);
    const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
    const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

    float4 q[D / 4];
    const float4* qp = reinterpret_cast<const float4*>(qb + qrow * a.q_sn);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
        const float4 t = qp[i];
        const float sc = a.qk_scale;
        q[i] = make_float4(t.x * sc, t.y * sc, t.z * sc, t.w * sc);
    }
    float4 acc[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = NEG_INF, l = 0.f, pad = 0.f;
    const int num_tiles = (kend + F32_BK - 1) / F32_BK;

    if constexpr (SM == SM_TWO_PASS) {
        float mp = NEG_INF;
        for (int t = 0; t < num_tiles; ++t) {
            __syncthreads();
            f32_load<THREADS>(ks, nullptr, kb, a.k_sn, vb, a.v_sn, t * F32_BK, n, tid);  // K only
            __syncthreads();
            float s[F32_BK];
            f32_logits(s, q, ks, t * F32_BK, kend);
#pragma unroll
            for (int j = 0; j < F32_BK; ++j) mp = fmaxf(mp, s[j]);
            if ((t + 1) * F32_BK % a.panel == 0 || t + 1 == num_tiles) {  // the panel's end
                m = fmaxf(m, mp);
                mp = NEG_INF;
            }
        }
    }
    for (int t = 0; t < num_tiles; ++t) {
        const int k0 = t * F32_BK;
        __syncthreads();  // the previous tile has been consumed
        f32_load<THREADS>(ks, vs, kb, a.k_sn, vb, a.v_sn, k0, n, tid);
        __syncthreads();
        float s[F32_BK];
        f32_logits(s, q, ks, k0, kend);
        if constexpr (SM == SM_ONLINE) {
            float m_new = m;
#pragma unroll
            for (int j = 0; j < F32_BK; ++j) m_new = fmaxf(m_new, s[j]);
            const float alpha = expf_mode<MODE>(m - m_new);
            m = m_new;
            l *= alpha;
            pad *= alpha;
#pragma unroll
            for (int i = 0; i < D / 4; ++i) {
                acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
            }
        }
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) {
            float p;
            if constexpr (SM == SM_ONLINE || MODE == MODE_STAGED) {
                p = expf_mode<MODE>(s[j] - m);
                l += p;
            } else if constexpr (MODE == MODE_MAXONLY) {
                p = k0 + j < kend ? s[j] - m : 0.f;
            } else {
                p = k0 + j < kend ? plain_weight<MODE>(s[j]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < D / 4; ++i) {
                const float4 vv = vs[j][i];
                acc[i].x = fmaf(p, vv.x, acc[i].x);
                acc[i].y = fmaf(p, vv.y, acc[i].y);
                acc[i].z = fmaf(p, vv.z, acc[i].z);
                acc[i].w = fmaf(p, vv.w, acc[i].w);
            }
        }
        if constexpr (MODE == MODE_PADFIX) {
            const int hi = min(k0 + F32_BK, kend);
            for (int e = (k0 / a.chunk + 1) * a.chunk; e <= hi; e += a.chunk) {
                const int pads = chunk_pads(e, a.chunk, n);
                if (pads > 0) pad += (float)pads * exp2f(-m);
            }
        }
    }

    if (qi < n) {
        constexpr bool NORMALIZED = SM == SM_ONLINE || MODE == MODE_STAGED;
        const float lr = NORMALIZED ? fmaxf(l - pad, 1e-30f) : 1.f;
        float4* op = reinterpret_cast<float4*>(static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh + qi * a.o_sn);
#pragma unroll
        for (int i = 0; i < D / 4; ++i) op[i] = make_float4(acc[i].x / lr, acc[i].y / lr, acc[i].z / lr, acc[i].w / lr);
    }
}

template <int QP, bool PIPELINED, int MODE>
cudaError_t launch_variant(const VArgs& a, int dtype, dim3 grid, cudaStream_t s) {
    if (dtype == 0) {
        fv_f32<QP, MODE><<<grid, 64 * QP, 0, s>>>(a);
    } else {
        fv_bf16<QP, PIPELINED, MODE><<<grid, 128 * QP, 0, s>>>(a);
    }
    return cudaGetLastError();
}

// Slots of the C entries' int64 argument array, one layout for #10, #11 and #12.
enum Slot {
    SLOT_Q = 0,      // q: address, then batch, row and head strides
    SLOT_K = 4,      // k: the same
    SLOT_V = 8,      // v: the same
    SLOT_O = 12,     // out: the same
    SLOT_BATCH = 16,
    SLOT_N,          // q rows and real keys
    SLOT_KEYS,       // keys taken (kend)
    SLOT_HEADS,
    SLOT_HEAD_DIM,
    SLOT_DTYPE,      // q, k, v and out: 0 = float32, 1 = bfloat16
    SLOT_DEVICE,     // the CUDA device of every tensor
    SLOT_MODE,       // the Mode
    SLOT_QP,         // q blocks of 64 rows per CTA: 1, 2 or 4
    SLOT_PIPELINED,  // 1: key tile t+1's QK^T issued before tile t's softmax
    SLOT_PANEL,      // two-pass modes: keys per panel, a positive multiple of 64
    SLOT_CHUNK,      // MODE_PADFIX: keys per chunk
    NUM_SLOTS,
};

// Decode and check the argument array, switch to its device, call
// launch(args, mode, qp, pipelined, dtype, grid, stream) and switch back.
// Returns the cudaError_t (0 on success).
template <class Launch>
int variant_entry(const long long* args, float qk_scale, void* stream, Launch launch) {
    const int batch = (int)args[SLOT_BATCH], n = (int)args[SLOT_N], kend = (int)args[SLOT_KEYS];
    const int heads = (int)args[SLOT_HEADS], dtype = (int)args[SLOT_DTYPE], device = (int)args[SLOT_DEVICE];
    const int mode = (int)args[SLOT_MODE], qp = (int)args[SLOT_QP], pipelined = (int)args[SLOT_PIPELINED];
    const int panel = (int)args[SLOT_PANEL], chunk = (int)args[SLOT_CHUNK];
    if (args[SLOT_HEAD_DIM] != D || n < 1 || kend < 1 || batch < 1 || heads < 1 || batch > 65535 || heads > 65535)
        return (int)cudaErrorInvalidValue;
    if ((dtype != 0 && dtype != 1) || (qp != 1 && qp != 2 && qp != 4) || panel < BK || panel % BK != 0 || chunk < 1)
        return (int)cudaErrorInvalidValue;
    const long long* q = args + SLOT_Q;
    const long long* k = args + SLOT_K;
    const long long* v = args + SLOT_V;
    const long long* o = args + SLOT_O;
    const VArgs a{reinterpret_cast<const void*>(q[0]), reinterpret_cast<const void*>(k[0]),
                  reinterpret_cast<const void*>(v[0]), reinterpret_cast<void*>(o[0]),
                  q[1], q[2], q[3], k[1], k[2], k[3], v[1], v[2], v[3], o[1], o[2], o[3],
                  n, kend, panel, chunk, qk_scale};
    const dim3 grid((n + 64 * qp - 1) / (64 * qp), heads, batch);
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = launch(a, mode, qp, pipelined != 0, dtype, grid, static_cast<cudaStream_t>(stream));
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}

}  // namespace
