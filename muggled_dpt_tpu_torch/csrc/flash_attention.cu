// Flash attention for Hopper (sm_90a), float32, bfloat16 and float16, on
// strided q, k and v with an optional additive bias: the C entry of every
// launch, and the kernels of the float32 launches and of the 16-bit launches
// the sm_90 kernel does not take. Routing, by dtype alone (T: bf16 or f16):
//   T q/k/v, no bias or a bias of type T -> flash_attention_sm90.cu (wgmma,
//                                           TMA, a warp-specialised producer)
//   T q/k/v, a float32 bias              -> fa_mma<T> here (no model path
//                                           sends one: the models hand the
//                                           bias over in their own dtype)
//   float32, no bias or a float32 or bf16 one -> fa_f32 here (the parity mode)
//   a float16 bias beside bf16 or float32 q/k/v, a bf16 bias beside float16
//   ones: refused (cudaErrorInvalidValue)
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
// The kernels here: one CTA per (q tile of 64 rows, head, batch),
// FlashAttention-2 style. K/V tiles stream through shared memory at every
// N; each q row keeps a running (max m, sum l, accumulator acc) in
// registers. That one streaming loop replaces the TPU's one-pass/online
// split, its whole-row VMEM residency, its head grouping (hpp) and its bias
// downcast, which were TPU tactics. fa_mma runs both products on the
// tensor cores with mma.sync m16n8k16 (T in, f32 out), K/V
// double-buffered by cp.async, and reads its float32 bias from global
// memory into registers in the layout of the logits it is added to, one
// key tile ahead; a unit column stride with even rows gets its own
// instantiation with 8-byte loads. fa_f32 uses plain FMAs, since TF32
// tensor cores would not hold float32 accuracy.
// Numerics kept from the TPU kernels:
//   * exp2 domain: logits are s * scale * log2(e) + bias * log2(e), in f32,
//     equal to the natural-exp softmax of s * scale + bias. The f32 kernel
//     folds scale * log2(e) into q; the T kernel applies it to the f32
//     logits, so q is not rounded to T a second time;
//   * keys at or past N are replaced by NEG_INF, whatever the bias holds
//     there (never an analytic pad-count correction, which fails when every
//     logit is very negative);
//   * logits, softmax and accumulation in f32; p is rounded to the input
//     type before the PV product; out = acc / max(l, 1e-30);
//   * q rows past N are computed on zero input and never written.
// The mma.sync, cp.async and ldmatrix helpers live in flash_tile.cuh, whose
// constants the measurement variants' float32 template shares.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"

// flash_attention_sm90.cu: every bfloat16 (half false) or float16 (half true) launch without a bias or with one of q's type
cudaError_t flash_attention_sm90(bool half, const void* q, const long long* q_st, const void* k, const long long* k_st,
                                 const void* v, const long long* v_st, void* o, const long long* o_st, const void* bias,
                                 const long long* bias_st, int fill, int batch, int n, int heads, float qk_scale_log2,
                                 cudaStream_t stream);

namespace {

// bias element types: template argument BIAS
constexpr int BIAS_NONE = 0, BIAS_F32 = 1, BIAS_BF16 = 2;
// the argument array's dtype codes (SLOT_DTYPE, SLOT_BIAS_DTYPE)
constexpr int CODE_NONE = -1, CODE_F32 = 0, CODE_BF16 = 1, CODE_F16 = 2;

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
// bfloat16 or float16 (T) with a float32 bias: tensor-core kernel, 4 warps x
// 16 q rows, mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // q rows per CTA (16 per warp)
constexpr int THREADS = 128;

// Copy 64 rows x 64 columns of one head's q, k or v into shared memory: 512
// chunks of 16 B, 4 per thread. This thread copies rows r0 + 16i (i = 0..3)
// at column c0: p points at row r0 of the tile, at column c0; `first` is
// the tile's first row; `fallback` is a valid address for rows past N.
template <typename T>
__device__ __forceinline__ void load_tile(T (*dst)[LDS], const T* p, long long step16, int first, int n, int r0, int c0,
                                          const T* fallback) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool valid = first + r0 + 16 * i < n;
        cp_async16(&dst[r0 + 16 * i][c0], valid ? p + i * step16 : fallback, valid);
    }
}

// This thread's float32 bias for the 64-key tile at kbase, in the S
// C-fragment layout: rows g and g + 8 (row pointers row_g, row_g8; null
// past N), columns 2cq and 2cq + 1 of each 8-key tile nt; 0 past N.
template <bool PAIRS>
__device__ __forceinline__ void bias_fetch(float2 (&raw)[2][BK / 8], const Args& a, const float* row_g, const float* row_g8,
                                           int kbase, int n, int cq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float* row = r == 0 ? row_g : row_g8;
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
            const int key = kbase + nt * 8 + 2 * cq;
            float2 v{0.f, 0.f};
            if (row != nullptr) {
                if constexpr (PAIRS) {  // column stride 1: immediate offsets off the row pointer
                    if (key + 1 < n) {
                        v = *reinterpret_cast<const float2*>(row + key);
                    } else if (key < n) {
                        v.x = row[key];
                    }
                } else {
                    if (key < n) v.x = row[key * a.b_sk];
                    if (key + 1 < n) v.y = row[(key + 1) * a.b_sk];
                }
            }
            raw[r][nt] = v;
        }
    }
}

template <typename T, bool PAIRS>
__global__ void __launch_bounds__(THREADS) fa_mma(const Args a) {
    __shared__ __align__(16) T qs[BQ][LDS];
    __shared__ __align__(16) T ks[2][BK][LDS];
    __shared__ __align__(16) T vs[2][BK][LDS];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;  // fragment row group and column pair
    const int n = a.n;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
    // this thread's share of every tile copy: rows r0 + 16i, 16-byte column chunk c0
    const int r0 = tid / (D / 8), c0 = (tid % (D / 8)) * 8;
    const T* kt = kb + r0 * a.k_sn + c0;  // advanced by one tile per iteration
    const T* vt = vb + r0 * a.v_sn + c0;
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
    const float* head = static_cast<const float*>(a.bias) + a.b_off + b * a.b_sb + h * a.b_sh;
    const float* bias_g = row_g < n ? head + row_g * a.b_sn : nullptr;             // bias row of logit row row_g
    const float* bias_g8 = row_g + 8 < n ? head + (row_g + 8) * a.b_sn : nullptr;  // and of row_g + 8
    float2 bias_next[2][BK / 8];
    bias_fetch<PAIRS>(bias_next, a, bias_g, bias_g8, 0, n, cq);

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

        float2 bias_cur[2][BK / 8];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) bias_cur[r][nt] = bias_next[r][nt];
        if (t + 1 < num_tiles) bias_fetch<PAIRS>(bias_next, a, bias_g, bias_g8, (t + 1) * BK, n, cq);

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
                const T* kp = &ks[st][nt * 8 + g][kk * 16 + 2 * cq];
                mma_16816<T>(s[nt], qf[kk], ld_u32(kp), ld_u32(kp + 8));
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
                const float2 bp = bias_cur[e >> 1][nt];
                float v = fmaf(s[nt][e], a.qk_scale_log2, ((e & 1) ? bp.y : bp.x) * LOG2E);
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

        // P = exp2(S - m), rounded to T; the S C-fragments of key tiles
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
                pf[j][2 * half] = pack2<T>(p0, p1);
                pf[j][2 * half + 1] = pack2<T>(p2, p3);
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
                mma_16816<T>(acc[2 * dp], pf[j], vfrag[0], vfrag[1]);
                mma_16816<T>(acc[2 * dp + 1], pf[j], vfrag[2], vfrag[3]);
            }
        }
        __syncthreads();  // this stage is refilled two iterations on
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        if (row < n) {
            const float lr = fmaxf(l_r[r], 1e-30f);
            T* op = ob + row * a.o_sn;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt)
                *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * cq) = pack2<T>(acc[dt][2 * r] / lr, acc[dt][2 * r + 1] / lr);
        }
    }
}

// Every launch but those flash_attention_sm90.cu takes (bf16 or f16 without
// a bias or with one of q's type): fa_f32<BIAS> for float32 q/k/v, fa_mma<T>
// for T q/k/v with a float32 bias. pairs: the float32 bias
// has column stride 1 and every bias row starts at an even element, so
// fa_mma loads bias pairs at immediate offsets.
template <int BIAS>
cudaError_t launch_f32(const Args& a, dim3 grid, cudaStream_t s) {
    fa_f32<BIAS><<<grid, F32_BQ, 0, s>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma(const Args& a, bool pairs, dim3 grid, cudaStream_t s) {
    if (pairs) {
        fa_mma<T, true><<<grid, THREADS, 0, s>>>(a);
    } else {
        fa_mma<T, false><<<grid, THREADS, 0, s>>>(a);
    }
    return cudaGetLastError();
}

cudaError_t launch_any(const Args& a, int dtype, int bias_dtype, int fill, int batch, int num_heads, cudaStream_t s) {
    if (dtype != CODE_F32 && bias_dtype != CODE_F32) {
        if (bias_dtype != CODE_NONE && bias_dtype != dtype) return cudaErrorInvalidValue;  // bf16 with f16, or f16 with bf16
        const long long qs[3] = {a.q_sb, a.q_sn, a.q_sh}, ks[3] = {a.k_sb, a.k_sn, a.k_sh};
        const long long vs[3] = {a.v_sb, a.v_sn, a.v_sh}, os[3] = {a.o_sb, a.o_sn, a.o_sh};
        const long long bs[4] = {a.b_sb, a.b_sh, a.b_sn, a.b_sk};
        const void* bias = bias_dtype == CODE_NONE ? nullptr : static_cast<const char*>(a.bias) + a.b_off * 2;
        return flash_attention_sm90(dtype == CODE_F16, a.q, qs, a.k, ks, a.v, vs, a.o, os, bias, bs, fill, batch, a.n,
                                    num_heads, a.qk_scale_log2, s);
    }
    const dim3 grid((a.n + BQ - 1) / BQ, num_heads, batch);  // F32_BQ == BQ: one q tile of 64 rows per CTA
    if (dtype == CODE_F32) {
        if (bias_dtype == CODE_NONE) return launch_f32<BIAS_NONE>(a, grid, s);
        if (bias_dtype == CODE_F32) return launch_f32<BIAS_F32>(a, grid, s);
        if (bias_dtype == CODE_BF16) return launch_f32<BIAS_BF16>(a, grid, s);
        return cudaErrorInvalidValue;  // a float16 bias: no float32 instance
    }
    const uintptr_t first = reinterpret_cast<uintptr_t>(a.bias) + (uintptr_t)(a.b_off * 4);
    const bool pairs = a.b_sk == 1 && first % 8 == 0 && a.b_sb % 2 == 0 && a.b_sh % 2 == 0 && a.b_sn % 2 == 0;
    return dtype == CODE_F16 ? launch_mma<__half>(a, pairs, grid, s) : launch_mma<__nv_bfloat16>(a, pairs, grid, s);
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
    SLOT_DTYPE,        // q, k, v and out: 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_BIAS_DTYPE,   // -1 = no bias, 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_DEVICE,       // the CUDA device of every tensor
    SLOT_BIAS_FILL,    // a 16-bit bias of q/k/v's type: 0 = tensor map (TMA), 1 = copied by the producer's warps
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
    const int fill = (int)args[SLOT_BIAS_FILL];
    const void* bias = reinterpret_cast<const void*>(args[SLOT_BIAS]);
    if (args[SLOT_HEAD_DIM] != D || n < 1 || batch < 1 || num_heads < 1 || batch > 65535 || num_heads > 65535)
        return (int)cudaErrorInvalidValue;
    if (dtype < CODE_F32 || dtype > CODE_F16 || bias_dtype < CODE_NONE || bias_dtype > CODE_F16 ||
        (bias_dtype != CODE_NONE && bias == nullptr) || (fill != 0 && fill != 1))
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
    err = launch_any(a, dtype, bias_dtype, fill, batch, num_heads, static_cast<cudaStream_t>(stream));
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
