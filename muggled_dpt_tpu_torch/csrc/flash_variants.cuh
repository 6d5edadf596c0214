// Measurement variants of flash attention #1 for Hopper (sm_90a): the C
// entries of the attention sweep's kernels, their one argument layout (enum
// Slot), and the float32 kernel template, the variant chosen by template
// parameters. Three sources include it, each its own nvcc job:
//   #10 flash_attention_xl.cu     <- experiments/flash_attention_xl.py:_xl_qkv_kernel (:69)
//   #11 flash_attention_staged.cu <- experiments/flash_attention_staged.py:_staged_qkv_kernel (:74)
//   #12 flash_variant.cu          <- tools/attn_variants.py:_onepass_kernel (:77), _innerloop_kernel (:110)
// No model serves through them, as in the JAX package: they are the
// attention sweep's variants (muggled_dpt_tpu_torch/tools/flash_tune.py).
// Which kernel a launch reaches:
//   #10 bf16 (MODE_FLASH, MODE_ABLATE; qp, pipelined)  flash_xl_sm90.cu (wgmma, TMA)
//   #11 bf16 (MODE_STAGED; panel)                      flash_staged_sm90.cu (wgmma, TMA)
//   #12 bf16 (the #12 modes)                           flash_variant_sm90.cu (wgmma, TMA)
//   #10, #11, #12 float32                              fv_f32 below (FMAs; #10's qp)
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
//                   each key panel reduces its own max and the row max is
//                   the maximum of the panels'. Pass 2 recomputes QK^T,
//                   streams K and V, and takes p = exp2(s - m), PV and the
//                   row sum. The panels run in sequence in one CTA (no
//                   split-K grid): a 64-row f32 logit block at N=18497 is
//                   4.7 MB, so it is recomputed, never kept. Max is exact,
//                   so the output does not depend on the panels at all;
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
// f32 (fv_f32): #1's FMA kernel, one thread per q row, QP * 64 threads per
// CTA sharing 32-key tiles (#10's qp); pipelining has no meaning there and
// is ignored.
//
// Bounds on an H100: 4 B H N^2 D operations (QK^T and PV) against 4 B N H D
// bf16 elements moved: at N=18497, 16 heads, one call is 1.40 TFLOP,
// 1.417 ms at the dense bf16 peak, compute bound by far (#11's recompute
// pass is the implementation's, not the function's).

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

// float32 launches (every entry).
template <int QP, int MODE>
cudaError_t launch_f32(const VArgs& a, dim3 grid, cudaStream_t s) {
    fv_f32<QP, MODE><<<grid, 64 * QP, 0, s>>>(a);
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
    SLOT_QP,         // q blocks of 64 rows per CTA: 1, 2 or 4 (bf16 #10: consumer warpgroups)
    SLOT_PIPELINED,  // 1: key tile t+1's QK^T issued before tile t's softmax
    SLOT_PANEL,      // two-pass modes: keys per panel, a positive multiple of 64 (bf16 #11: of 128)
    SLOT_CHUNK,      // MODE_PADFIX: keys per chunk
    NUM_SLOTS,
};

// Whether 4-D tensor maps read q, k and v, and out, as the slots give them:
// 16-byte aligned bases and, on every dim of size > 1, a positive stride of
// a multiple of 8 bf16 elements (16 bytes) below 2^39 elements (TMA's 2^40
// bytes). The head dim is unit-stride by the slots' layout.
bool tma_readable(const long long* args) {
    const long long sizes[3] = {args[SLOT_BATCH], args[SLOT_N], args[SLOT_HEADS]};
    for (int slot = SLOT_Q; slot <= SLOT_O; slot += 4) {
        if (args[slot] % 16 != 0) return false;
        for (int i = 0; i < 3; ++i) {
            const long long st = args[slot + 1 + i];
            if (sizes[i] > 1 && (st <= 0 || st % 8 != 0 || st >= (1ll << 39))) return false;
        }
    }
    return true;
}

// The (batch, row, head) element strides of q, k, v and out, for the sm_90 kernels.
struct Strides {
    long long q[3], k[3], v[3], o[3];
};

Strides strides_of(const VArgs& a) {
    return {{a.q_sb, a.q_sn, a.q_sh}, {a.k_sb, a.k_sn, a.k_sh}, {a.v_sb, a.v_sn, a.v_sh}, {a.o_sb, a.o_sn, a.o_sh}};
}

// Decode and check the argument array, switch to its device, call
// launch(a, mode, qp, pipelined, dtype, grid, stream) and switch back. A
// bfloat16 launch runs the entry's wgmma/TMA kernel, so its layout must be
// one tensor maps read, and all N keys are taken unless `any_keys` (#12,
// whose keys include pad keys or end at a chunk cut); anything else is
// refused. Returns the cudaError_t (0 on success).
template <class Launch>
int variant_entry(const long long* args, float qk_scale, void* stream, bool any_keys, Launch launch) {
    const int batch = (int)args[SLOT_BATCH], n = (int)args[SLOT_N], kend = (int)args[SLOT_KEYS];
    const int heads = (int)args[SLOT_HEADS], dtype = (int)args[SLOT_DTYPE], device = (int)args[SLOT_DEVICE];
    const int mode = (int)args[SLOT_MODE], qp = (int)args[SLOT_QP], pipelined = (int)args[SLOT_PIPELINED];
    const int panel = (int)args[SLOT_PANEL], chunk = (int)args[SLOT_CHUNK];
    if (args[SLOT_HEAD_DIM] != D || n < 1 || kend < 1 || batch < 1 || heads < 1 || batch > 65535 || heads > 65535)
        return (int)cudaErrorInvalidValue;
    if ((dtype != 0 && dtype != 1) || (qp != 1 && qp != 2 && qp != 4) || panel < BK || panel % BK != 0 || chunk < 1)
        return (int)cudaErrorInvalidValue;
    const bool sm90 = dtype == 1;
    if (sm90 && !((any_keys || kend == n) && tma_readable(args))) return (int)cudaErrorInvalidValue;
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
