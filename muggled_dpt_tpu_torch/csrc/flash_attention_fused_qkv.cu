// Fused-qkv flash attention for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the TPU kernel
//   muggled_dpt_tpu/ops/pallas/flash_attention.py:_onepass_qkv_kernel
// on its unbiased path (flash_attention_fused_qkv). It computes, per batch
// and head, out = softmax(q k^T * scale) v, reading q, k and v in place from
// the fused qkv projection output:
//   qkv (B, N, 3C), head-major columns: head h has q at h*3D + [0, D),
//       k at h*3D + [D, 2D), v at h*3D + [2D, 3D); C = H * D, D = 64.
//   out (B, N, C), head h in columns h*D + [0, D).
// No transposes and no host-side split.
//
// Design: one CTA per (q tile of 64 rows, head, batch), FlashAttention-2
// style. K/V tiles stream through shared memory; each q row keeps a running
// (max m, sum l, accumulator acc) in registers. This replaces the TPU
// kernel's whole-row VMEM residency and its head grouping (hpp), which were
// TPU tactics. Numerics kept from the TPU kernel:
//   * exp2 domain: scale * log2(e) is one constant (qk_scale_log2). The f32
//     kernel folds it into q; the bf16 kernel applies it to the f32 logits,
//     so q is not rounded to bf16 a second time.
//   * keys past N in the tail tile are replaced by NEG_INF (never an analytic
//     pad-count correction, which fails when every logit is very negative);
//   * logits, softmax and accumulation in f32; p is rounded to the input
//     type before the PV product; out = acc / max(l, 1e-30);
//   * q rows past N are computed on zero input and never written.
//
// Bounds on an H100: at N=1297, D=64, 16 heads one call does about
// 2 * 2 * N^2 * D * H = 6.9 GFLOP per image against 3 * N * C * 2 B = 8 MB of
// bf16 qkv, so it is compute bound. The bf16 kernel runs both products on
// the tensor cores with mma.sync m16n8k16 (bf16 in, f32 out), with K/V
// double-buffered by cp.async; the f32 kernel (the parity mode) uses plain
// FMAs, since TF32 tensor cores would not hold float32 accuracy.
// Left for later: wgmma and TMA with a warp-specialised producer, keeping P
// in registers across a 64-row warpgroup tile, and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // head dim
constexpr float NEG_INF = -1e30f;  // the JAX package's masking constant

// ---------------------------------------------------------------------------
// float32: SIMT kernel, one thread per q row
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;  // q rows per CTA == threads per CTA
constexpr int F32_BK = 32;  // keys per shared-memory tile

__global__ void __launch_bounds__(F32_BQ)
fa_fused_qkv_f32(const float* __restrict__ qkv, float* __restrict__ out, int n, int num_heads, float qk_scale_log2) {
    __shared__ float4 ks[F32_BK][D / 4];
    __shared__ float4 vs[F32_BK][D / 4];

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x;
    const int qi = blockIdx.x * F32_BQ + tid;
    const int c = num_heads * D;
    const size_t row_stride = 3 * (size_t)c;
    const float* base = qkv + (size_t)b * n * row_stride + (size_t)h * 3 * D;

    float4 q[D / 4];
    const float4* qp = reinterpret_cast<const float4*>(base + (size_t)min(qi, n - 1) * row_stride);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
        const float4 t = qp[i];
        q[i] = make_float4(t.x * qk_scale_log2, t.y * qk_scale_log2, t.z * qk_scale_log2, t.w * qk_scale_log2);
    }

    float4 acc[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = NEG_INF, l = 0.f;

    for (int k0 = 0; k0 < n; k0 += F32_BK) {
        __syncthreads();  // the previous tile has been consumed
        for (int idx = tid; idx < F32_BK * D / 4; idx += F32_BQ) {
            const int r = idx / (D / 4), c4 = idx % (D / 4);
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (k0 + r < n) {
                const float4* rp = reinterpret_cast<const float4*>(base + (size_t)(k0 + r) * row_stride);
                kv = rp[D / 4 + c4];
                vv = rp[2 * D / 4 + c4];
            }
            ks[r][c4] = kv;
            vs[r][c4] = vv;
        }
        __syncthreads();

        float s[F32_BK];
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
        float4* op = reinterpret_cast<float4*>(out + ((size_t)b * n + qi) * c + (size_t)h * D);
#pragma unroll
        for (int i = 0; i < D / 4; ++i)
            op[i] = make_float4(acc[i].x / lr, acc[i].y / lr, acc[i].z / lr, acc[i].w / lr);
    }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel, 4 warps x 16 q rows, mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // q rows per CTA (16 per warp)
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int LDS = D + 8;   // padded shared row (bf16 elements): conflict-free fragment loads

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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// Copy a 64-row x 64-column bf16 tile (rows row0.., columns col0.. of this
// head's slab) into shared memory: 512 chunks of 16 B, 4 per thread.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[LDS], const __nv_bfloat16* base, size_t row_stride,
                                          int row0, int col0, int n, int tid) {
#pragma unroll
    for (int i = 0; i < 64 * D / 8 / THREADS; ++i) {
        const int chunk = tid + i * THREADS;
        const int r = chunk / (D / 8), c8 = chunk % (D / 8);
        const int row = row0 + r;
        const bool valid = row < n;
        cp_async16(&dst[r][c8 * 8], base + (size_t)(valid ? row : 0) * row_stride + col0 + c8 * 8, valid);
    }
}

__global__ void __launch_bounds__(THREADS)
fa_fused_qkv_bf16(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int n, int num_heads,
                  float qk_scale_log2) {
    __shared__ __align__(16) __nv_bfloat16 qs[BQ][LDS];
    __shared__ __align__(16) __nv_bfloat16 ks[2][BK][LDS];
    __shared__ __align__(16) __nv_bfloat16 vs[2][BK][LDS];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;  // fragment row group and column pair
    const int c = num_heads * D;
    const size_t row_stride = 3 * (size_t)c;
    const __nv_bfloat16* base = qkv + (size_t)b * n * row_stride + (size_t)h * 3 * D;

    load_tile(qs, base, row_stride, q0, 0, n, tid);
    load_tile(ks[0], base, row_stride, 0, D, n, tid);
    load_tile(vs[0], base, row_stride, 0, 2 * D, n, tid);
    cp_async_commit();

    uint32_t qf[D / 16][4];  // this warp's Q A-fragments, one per 16-wide k step
    float acc[D / 8][4];     // O C-fragments, one per 8-wide column tile
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp's 16
    float l_r[2] = {0.f, 0.f};          // per-thread partial sums, reduced at the end

    const int num_tiles = (n + BK - 1) / BK;
    for (int t = 0; t < num_tiles; ++t) {
        const int st = t & 1;
        if (t + 1 < num_tiles) {
            load_tile(ks[st ^ 1], base, row_stride, (t + 1) * BK, D, n, tid);
            load_tile(vs[st ^ 1], base, row_stride, (t + 1) * BK, 2 * D, n, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        if (t == 0) {
            const int r0 = warp * 16 + g;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                qf[kk][0] = ld_u32(&qs[r0][kk * 16 + 2 * cq]);
                qf[kk][1] = ld_u32(&qs[r0 + 8][kk * 16 + 2 * cq]);
                qf[kk][2] = ld_u32(&qs[r0][kk * 16 + 2 * cq + 8]);
                qf[kk][3] = ld_u32(&qs[r0 + 8][kk * 16 + 2 * cq + 8]);
            }
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

        // exp2-domain logits, tail keys masked, running row max
        const int kbase = t * BK;
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kbase + nt * 8 + 2 * cq + (e & 1);
                const float v = key < n ? s[nt][e] * qk_scale_log2 : NEG_INF;
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
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, &vs[st][j * 16 + (mtx & 1) * 8 + mrow][dp * 16 + (mtx >> 1) * 8]);
                mma_16816(acc[2 * dp], pf[j], vb[0], vb[1]);
                mma_16816(acc[2 * dp + 1], pf[j], vb[2], vb[3]);
            }
        }
        __syncthreads();  // this stage is refilled two iterations on
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row < n) {
            const float lr = fmaxf(l_r[r], 1e-30f);
            __nv_bfloat16* op = out + ((size_t)b * n + row) * c + (size_t)h * D;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt)
                *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * cq) = pack_bf16(acc[dt][2 * r] / lr, acc[dt][2 * r + 1] / lr);
        }
    }
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. Returns
// the cudaError_t of the launch (0 on success); the launch is asynchronous
// on `stream`.
extern "C" int mdpt_flash_attention_fused_qkv(const void* qkv, void* out, int batch, int n, int num_heads,
                                              int head_dim, float qk_scale_log2, int dtype, int device,
                                              void* stream) {
    if (head_dim != D || n < 1 || batch < 1 || num_heads < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + BQ - 1) / BQ, num_heads, batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        fa_fused_qkv_f32<<<grid, F32_BQ, 0, s>>>(static_cast<const float*>(qkv), static_cast<float*>(out), n,
                                                 num_heads, qk_scale_log2);
    } else if (dtype == 1) {
        fa_fused_qkv_bf16<<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(qkv),
                                                   static_cast<__nv_bfloat16*>(out), n, num_heads, qk_scale_log2);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
