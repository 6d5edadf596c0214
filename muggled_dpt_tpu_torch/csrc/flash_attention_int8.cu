// Flash attention with an int8 QK^T for Hopper (sm_90a), the C entry and
// the float32 kernel: q and k quantized to int8 with float32 row scales,
// v and the output in bfloat16 or float32.
//
// Replaces two TPU kernels of experiments/flash_attention_int8.py with
// their XLA prologues:
//   #6 flash_attention_int8_qk       -> _online_kernel_i8 (:44), (BH, N, D)
//   #7 flash_attention_int8_qk_fused -> _onepass_i8qk_kernel (:175), off the
//      head-major (B, N, 3C) qkv slab
// One call of mdpt_flash_attention_int8 runs, on the caller's stream, the
// quantize prologue of flash_attention_int8_sm90.cu (two launches, every
// dtype) into the wrapper's scratch, then the attention: bfloat16 v on the
// int8 wgmma/TMA kernel of flash_attention_int8_sm90.cu, float32 v on
// fa_int8_f32 below (float32 is the parity mode: TF32 on the tensor cores
// would not hold it). The call reports the route it took in SLOT_ROUTE.
// Per batch b and head h the attention computes
//   s[i, j] = float(int32(q_i8[b, i, h, :] . k_i8[b, j, h, :])) * alpha[b, h, i]
//   out[b, i, h, :] = sum_j exp2(s[i, j] - m_i) v[b, j, h, :] / sum_j exp2(s[i, j] - m_i)
// where alpha holds the row's and the head's scales, the softmax scale and
// log2(e) (#6 folds them all into alpha; #7 scales q before it is
// quantized), so the softmax runs in the exp2 domain.
//
// fa_int8_f32: one CTA per (q tile of 64 rows, head, batch), 4 warps of 16
// rows, FlashAttention-2 style: 64-key K/V tiles double-buffered through
// shared memory by cp.async, each row keeping a running max, sum and
// accumulator in registers.
//   * QK^T on the int8 tensor cores, mma.sync m16n8k32 (s8 x s8 -> s32): q
//     and k rows are D-contiguous, which is the row.col operand order, so
//     both fragments are plain 4-byte loads from shared memory (rows padded
//     to 80 bytes: conflict-free). |q . k| <= 127^2 * 64 < 2^24, so the int32
//     logits convert to float32 exactly, and times alpha they equal the plain
//     version's logits bit for bit.
//   * PV on FMAs, each thread of a quad taking 16 of the 64 output columns
//     of its two rows and the quad's probabilities by shuffles.
//   * Keys at or past N are replaced by NEG_INF (never a pad-count
//     correction, which fails when every logit is very negative); q rows past
//     N are computed on zero input and never written; out = acc / max(l, 1e-30).
// Bound on an H100 at DA-V2 ViT-L's slab (B=8, N=1297, 16 heads): PV is
// 27.6 GFLOP on the FP32 pipe (0.41 ms at 67 TFLOP/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;              // head dim
constexpr float NEG_INF = -1e30f;  // the JAX package's masking constant
constexpr int BQ = 64;             // q rows per CTA (16 per warp)
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 128;
constexpr int LDI = D + 16;        // padded int8 row in bytes: conflict-free fragment loads

struct Args {
    const int8_t* q;
    const int8_t* k;
    const float* v;
    float* o;
    const float* alpha;
    long long q_sb, q_sn, q_sh;  // element strides: batch, row, head
    long long k_sb, k_sn, k_sh;
    long long v_sb, v_sn, v_sh;
    long long o_sb, o_sn, o_sh;
    long long a_sb, a_sh, a_sn;  // alpha: batch, head, row
    int n;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    // src-size 0 zero-fills the 16 bytes (rows past N)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ uint32_t ld_u32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

// s += a (16 x 32 int8, row) * b (32 x 8 int8, col), int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy 64 int8 rows of one head (64 bytes each) into shared memory: 256
// chunks of 16 B, 2 per thread, rows r0 and r0 + 32 at byte column c0.
__device__ __forceinline__ void load_i8_tile(int8_t (*dst)[LDI], const int8_t* base, long long sn, int first, int n,
                                             int r0, int c0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = first + r0 + 32 * i;
        const bool valid = row < n;
        cp_async16(&dst[r0 + 32 * i][c0], valid ? base + row * sn + c0 : base, valid);
    }
}

// Copy 64 rows of v (D float32 values each, 16 chunks) into shared memory, 8 chunks per thread (rows vr + 8i).
__device__ __forceinline__ void load_v_tile(float* dst, const float* base, long long sn, int first, int n, int tid) {
    constexpr int CHUNK = 4, PER_ROW = D / CHUNK, STEP = THREADS / PER_ROW;
    const int vr = tid / PER_ROW, vc = (tid % PER_ROW) * CHUNK;
#pragma unroll
    for (int i = 0; i < BK / STEP; ++i) {
        const int row = first + vr + STEP * i;
        const bool valid = row < n;
        cp_async16(dst + (vr + STEP * i) * D + vc, valid ? base + row * sn + vc : base, valid);
    }
}

__global__ void __launch_bounds__(THREADS) fa_int8_f32(const Args a) {
    __shared__ __align__(16) int8_t qs[BQ][LDI];
    __shared__ __align__(16) int8_t ks[2][BK][LDI];
    __shared__ __align__(16) float vs[2][BK][D];  // unpadded: 48 KB of static shared memory in all

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;  // fragment row group and column quad index
    const int n = a.n;
    const int8_t* qb = a.q + b * a.q_sb + h * a.q_sh;
    const int8_t* kb = a.k + b * a.k_sb + h * a.k_sh;
    const float* vb = a.v + b * a.v_sb + h * a.v_sh;
    const int r0 = tid / 4, c0 = (tid % 4) * 16;  // this thread's int8 chunks
    const int row_g = q0 + warp * 16 + g;         // this thread's logit rows: row_g and row_g + 8

    load_i8_tile(qs, qb, a.q_sn, q0, n, r0, c0);
    load_i8_tile(ks[0], kb, a.k_sn, 0, n, r0, c0);
    load_v_tile(&vs[0][0][0], vb, a.v_sn, 0, n, tid);
    cp_async_commit();

    float alpha_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        alpha_r[r] = row < n ? a.alpha[b * a.a_sb + h * a.a_sh + row * a.a_sn] : 0.f;
    }

    uint32_t qf[D / 32][4];  // this warp's Q A-fragments, one per 32-deep k step
    float acc[2][16];        // O: columns 16 cq .. 16 cq + 15 of rows g, g + 8
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};
    float l_r[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end

    const int num_tiles = (n + BK - 1) / BK;
    for (int t = 0; t < num_tiles; ++t) {
        const int st = t & 1;
        if (t + 1 < num_tiles) {
            load_i8_tile(ks[st ^ 1], kb, a.k_sn, (t + 1) * BK, n, r0, c0);
            load_v_tile(&vs[st ^ 1][0][0], vb, a.v_sn, (t + 1) * BK, n, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        if (t == 0) {
            const int rq = warp * 16 + g;
#pragma unroll
            for (int kk = 0; kk < D / 32; ++kk) {
                qf[kk][0] = ld_u32(&qs[rq][kk * 32 + 4 * cq]);
                qf[kk][1] = ld_u32(&qs[rq + 8][kk * 32 + 4 * cq]);
                qf[kk][2] = ld_u32(&qs[rq][kk * 32 + 16 + 4 * cq]);
                qf[kk][3] = ld_u32(&qs[rq + 8][kk * 32 + 16 + 4 * cq]);
            }
        }

        // S = Q K^T for this warp's 16 rows x 64 keys, exact in int32
        int si[BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
                const int8_t* kp = &ks[st][nt * 8 + g][kk * 32 + 4 * cq];
                mma_s8(si[nt], qf[kk], ld_u32(kp), ld_u32(kp + 16));
            }
        }

        // logits = float(S) * alpha (exp2 domain), tail keys replaced, running row max
        const int kbase = t * BK;
        float s[BK / 8][4];
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kbase + nt * 8 + 2 * cq + (e & 1);
                const float v = key < n ? __int2float_rn(si[nt][e]) * alpha_r[e >> 1] : NEG_INF;
                s[nt][e] = v;
                mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            corr[r] = exp2f(m_r[r] - mx[r]);
            m_r[r] = mx[r];
            l_r[r] *= corr[r];
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            acc[0][i] *= corr[0];
            acc[1][i] *= corr[1];
        }
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[nt][e] = exp2f(s[nt][e] - m_r[e >> 1]);
                l_r[e >> 1] += s[nt][e];
            }
        }
        // key j's probabilities live in lane (4g + (j % 8) / 2), element (j % 2) + 2r of tile j / 8
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const int src = (lane & ~3) | ((j & 7) >> 1);
            const float p0 = __shfl_sync(0xffffffffu, s[j >> 3][j & 1], src);
            const float p1 = __shfl_sync(0xffffffffu, s[j >> 3][(j & 1) + 2], src);
            const float4* vr = reinterpret_cast<const float4*>(&vs[st][j][16 * cq]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float4 vv = vr[c];
                acc[0][4 * c + 0] = fmaf(p0, vv.x, acc[0][4 * c + 0]);
                acc[0][4 * c + 1] = fmaf(p0, vv.y, acc[0][4 * c + 1]);
                acc[0][4 * c + 2] = fmaf(p0, vv.z, acc[0][4 * c + 2]);
                acc[0][4 * c + 3] = fmaf(p0, vv.w, acc[0][4 * c + 3]);
                acc[1][4 * c + 0] = fmaf(p1, vv.x, acc[1][4 * c + 0]);
                acc[1][4 * c + 1] = fmaf(p1, vv.y, acc[1][4 * c + 1]);
                acc[1][4 * c + 2] = fmaf(p1, vv.z, acc[1][4 * c + 2]);
                acc[1][4 * c + 3] = fmaf(p1, vv.w, acc[1][4 * c + 3]);
            }
        }
        __syncthreads();  // this stage is refilled two iterations on
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    float* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        if (row < n) {
            const float lr = fmaxf(l_r[r], 1e-30f);
            float4* o4 = reinterpret_cast<float4*>(ob + row * a.o_sn + 16 * cq);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                o4[c] = make_float4(acc[r][4 * c] / lr, acc[r][4 * c + 1] / lr, acc[r][4 * c + 2] / lr, acc[r][4 * c + 3] / lr);
        }
    }
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_Q = 0,        // q (float32 or bfloat16): address, then batch, row and head strides in elements
    SLOT_K = 4,        // k: the same
    SLOT_V = 8,        // v: the same
    SLOT_O = 12,       // out: the same
    SLOT_BATCH = 16,
    SLOT_N,
    SLOT_HEADS,
    SLOT_HEAD_DIM,
    SLOT_DTYPE,        // q, k, v and out: 0 = float32, 1 = bfloat16
    SLOT_MODE,         // alpha: 0 = sq sk (#7, q scaled first), 1 = ((sq sk) scale) log2(e) (#6)
    SLOT_DEVICE,       // the CUDA device of every tensor
    SLOT_Q_I8,         // scratch: (B, N, H, D) int8 q
    SLOT_K_I8,         // scratch: (B, N, H, D) int8 k
    SLOT_ALPHA,        // scratch: (B, H, N) float32 alpha
    SLOT_KMAX,         // scratch: (B, H, ceil(N / 64)) float32, the prologue's partial max |k|
    SLOT_STAGES,       // STAGE_PROLOGUE, STAGE_ATTENTION or both (a bit mask)
    SLOT_ROUTE,        // written by the call: ROUTE_SM90 or ROUTE_F32, the attention kernel that ran (or would have)
    NUM_SLOTS,
};

constexpr long long ROUTE_F32 = 0, ROUTE_SM90 = 1;
constexpr long long STAGE_PROLOGUE = 1, STAGE_ATTENTION = 2;

// Whether flash_attention_int8_sm90.cu's attention kernel takes the launch: every bfloat16 one.
bool sm90_takes(const long long* args) { return args[SLOT_DTYPE] == 1; }

}  // namespace

// flash_attention_int8_sm90.cu: the prologue (every launch) and the bfloat16 attention kernel
cudaError_t int8_prologue(const void* q, const long long* q_st, const void* k, const long long* k_st, int bf16, void* q_i8,
                          void* k_i8, float* alpha, float* kmax, int batch, int n, int heads, int mode, float q_mul, float scale,
                          cudaStream_t stream);
cudaError_t flash_attention_int8_sm90(const void* q_i8, const void* k_i8, const float* alpha, const void* v,
                                      const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads,
                                      cudaStream_t stream);

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot`. Strides are in elements; the head dim is contiguous in
// q, k, v and out, and the caller checks 16-byte alignment of their rows.
// The scratch is contiguous, allocated by the caller. `q_mul` multiplies q
// before it is quantized (#7: scale log2(e); #6: 1), `scale` enters #6's
// alpha. SLOT_STAGES says what runs: the prologue, the attention on the
// scratch as it stands, or both. The launches go to args[SLOT_DEVICE]; the
// calling thread's current device is the same after the call as before.
// The call writes its attention route to args[SLOT_ROUTE]. Returns the
// cudaError_t of the first launch that failed (0 on success); the launches
// are asynchronous on `stream`.
extern "C" int mdpt_flash_attention_int8(long long* args, float q_mul, float scale, void* stream) {
    const int batch = (int)args[SLOT_BATCH], n = (int)args[SLOT_N], num_heads = (int)args[SLOT_HEADS];
    const int dtype = (int)args[SLOT_DTYPE], device = (int)args[SLOT_DEVICE], mode = (int)args[SLOT_MODE];
    const long long stages = args[SLOT_STAGES];
    if (args[SLOT_HEAD_DIM] != D || n < 1 || batch < 1 || num_heads < 1 || batch > 65535 || num_heads > 65535)
        return (int)cudaErrorInvalidValue;
    if ((dtype != 0 && dtype != 1) || (mode != 0 && mode != 1) || stages < 1 || stages > 3) return (int)cudaErrorInvalidValue;
    const int pointers[] = {SLOT_Q, SLOT_K, SLOT_V, SLOT_O, SLOT_Q_I8, SLOT_K_I8, SLOT_ALPHA, SLOT_KMAX};
    for (int slot : pointers)
        if (args[slot] == 0) return (int)cudaErrorInvalidValue;
    const long long* q = args + SLOT_Q;
    const long long* k = args + SLOT_K;
    const long long* v = args + SLOT_V;
    const long long* o = args + SLOT_O;
    void* q_i8 = reinterpret_cast<void*>(args[SLOT_Q_I8]);
    void* k_i8 = reinterpret_cast<void*>(args[SLOT_K_I8]);
    float* alpha = reinterpret_cast<float*>(args[SLOT_ALPHA]);
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool sm90 = sm90_takes(args);
    args[SLOT_ROUTE] = sm90 ? ROUTE_SM90 : ROUTE_F32;
    if (stages & STAGE_PROLOGUE)
        err = int8_prologue(reinterpret_cast<const void*>(q[0]), q + 1, reinterpret_cast<const void*>(k[0]), k + 1, dtype, q_i8,
                            k_i8, alpha, reinterpret_cast<float*>(args[SLOT_KMAX]), batch, n, num_heads, mode, q_mul, scale, s);
    if (err == cudaSuccess && (stages & STAGE_ATTENTION)) {
        if (sm90) {
            err = flash_attention_int8_sm90(q_i8, k_i8, alpha, reinterpret_cast<const void*>(v[0]), v + 1,
                                            reinterpret_cast<void*>(o[0]), o + 1, batch, n, num_heads, s);
        } else {
            // the scratch: q_i8 and k_i8 (B, N, H, D), alpha (B, H, N)
            const long long hd = static_cast<long long>(num_heads) * D, nhd = hd * n, hn = static_cast<long long>(num_heads) * n;
            const Args a{static_cast<const int8_t*>(q_i8), static_cast<const int8_t*>(k_i8), reinterpret_cast<const float*>(v[0]),
                         reinterpret_cast<float*>(o[0]), alpha, nhd, hd, D, nhd, hd, D, v[1], v[2], v[3], o[1], o[2], o[3],
                         hn, n, 1, n};
            fa_int8_f32<<<dim3((n + BQ - 1) / BQ, num_heads, batch), THREADS, 0, s>>>(a);
            err = cudaGetLastError();
        }
    }
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
