// Fused LayerNorm -> fc1 -> GELU -> fc2 -> LayerScale residual for Hopper
// (sm_90a), float32 and bfloat16: the second half of a pre-norm transformer
// block with a GELU MLP,
//   out = x + ls * (fc2(gelu(fc1(layer_norm(x)))))
// on (rows, F) tokens, with torch-layout weights fc1 (H, F) and fc2 (F, H).
//
// Replaces TPU kernel #8: experiments/pallas_fused_mlp.py:fused_ln_mlp_residual
// (_kernel, :59). Its rounding points are kept: LayerNorm statistics and
// affine step in f32, the normalized rows rounded to x's type; fc1 summed in
// f32 plus b1; exact (erf) GELU in f32 (the TPU kernel's polynomial erf was a
// Mosaic workaround), rounded to x's type; fc2 summed in f32 plus b2, times
// ls, plus the f32 residual; one rounding at the end.
//
// Design: one CTA per BM rows. The normalized rows stay in shared memory for
// the whole CTA; the hidden width is walked in slabs of BH units, and each
// slab's fc1 rows and fc2 columns stream through shared memory with cp.async,
// the fc2 columns of slab s loading while slab s's fc1 product runs and slab
// s+1's fc1 rows loading while slab s's fc2 product runs. The (BM, F) f32
// accumulator of fc2 lives in registers, spread over the warps by output
// column, so neither the (rows, H) hidden activation nor the accumulator
// ever reaches global memory. The TPU kernel's (block_rows, F) VMEM
// accumulator does not fit a block's 227 KB at F = 1024, which is why BM is
// 32 rows (bf16) or 16 (f32) here.
//
// Bounds on an H100 at ViT-L, 504x504, B = 8 (10376 rows, F = 1024, H =
// 4096): 4 * rows * F * H = 174 GFLOP against 59 MB of bf16 tokens and
// weights, so the tensor cores bound it (0.176 ms at 989 TFLOP/s). The bf16
// kernel runs both products on them with mma.sync m16n8k16 (bf16 in, f32
// out); the f32 kernel (the parity mode) uses plain FMAs, since TF32 would not
// hold float32 accuracy. Every CTA streams all the weights (16.8 MB in bf16)
// from L2, so at B = 8 the L2 traffic is rows / 32 * 16.8 MB = 5.4 GB: this
// simple kernel is bound by L2 bandwidth, not by the tensor cores. Left for
// later: wgmma and TMA, a 64-row warpgroup tile and clusters that share one
// weight stream among several CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Args {
    const void* x;
    const void* ln_w;
    const void* ln_b;
    const void* w1;  // (H, F)
    const void* b1;  // (H,)
    const void* w2;  // (F, H)
    const void* b2;  // (F,)
    const void* ls;  // (F,)
    void* out;
    int rows, f, hidden;
    float eps;
};

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_F = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float gelu_erf(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// LayerNorm of rows row0 .. row0 + bm - 1 into shared memory (row stride ld),
// one warp per row; statistics and affine step in f32, rounded to T. Rows
// past the end are zero.
template <typename T>
__device__ void layer_norm_rows(const Args& a, int row0, int bm, T* xn, int ld) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const T* g = static_cast<const T*>(a.ln_w);
    const T* bb = static_cast<const T*>(a.ln_b);
    for (int r = warp; r < bm; r += WARPS) {
        const int row = row0 + r;
        T* dst = xn + r * ld;
        if (row >= a.rows) {
            for (int c = lane; c < a.f; c += 32) dst[c] = from_f<T>(0.f);
            continue;
        }
        const T* src = static_cast<const T*>(a.x) + (long long)row * a.f;
        float s = 0.f;
        for (int c = lane; c < a.f; c += 32) s += to_f(src[c]);
        const float mean = warp_sum(s) / a.f;
        float v = 0.f;
        for (int c = lane; c < a.f; c += 32) {
            const float d = to_f(src[c]) - mean;
            v = fmaf(d, d, v);
        }
        const float rstd = rsqrtf(warp_sum(v) / a.f + a.eps);
        for (int c = lane; c < a.f; c += 32) dst[c] = from_f<T>((to_f(src[c]) - mean) * rstd * to_f(g[c]) + to_f(bb[c]));
    }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BM = 32;   // rows per CTA: two 16-row m tiles
constexpr int BH = 32;   // hidden units per slab
constexpr int PAD = 8;   // bf16 row padding: conflict-free fragment loads, 16-byte rows
constexpr int MAX_NT = MAX_F / (8 * WARPS);  // 8-column fc2 tiles per warp at F = 1024

size_t bf16_smem_bytes(int f) {
    return sizeof(bf16) * ((size_t)BM * (f + PAD) + (size_t)BH * (f + PAD) + (size_t)f * (BH + PAD) + (size_t)BM * (BH + PAD));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

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

__global__ void __launch_bounds__(THREADS, 1) mlp_bf16(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int f = a.f, ldx = f + PAD, ldg = BH + PAD;
    bf16* xn = reinterpret_cast<bf16*>(smem);  // (BM, F) normalized rows
    bf16* w1s = xn + BM * ldx;                 // (BH, F) fc1 rows of the slab
    bf16* w2s = w1s + BH * ldx;                // (F, BH) fc2 columns of the slab
    bf16* gs = w2s + f * ldg;                  // (BM, BH) GELU output of the slab

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;  // fragment row group and column pair
    const int row0 = blockIdx.x * BM;
    const bf16* w1 = static_cast<const bf16*>(a.w1);
    const bf16* w2 = static_cast<const bf16*>(a.w2);
    const bf16* b1 = static_cast<const bf16*>(a.b1);
    const int slabs = a.hidden / BH;

    auto load_w1 = [&](int s) {  // BH rows of F: F / 8 chunks of 16 B each
        const int per_row = f / 8;
        for (int i = tid; i < BH * per_row; i += THREADS) {
            const int r = i / per_row, c = (i % per_row) * 8;
            cp_async16(w1s + r * ldx + c, w1 + (long long)(s * BH + r) * f + c);
        }
        cp_async_commit();
    };
    auto load_w2 = [&](int s) {  // F rows of BH: 4 chunks of 16 B each
        for (int i = tid; i < f * (BH / 8); i += THREADS) {
            const int r = i / (BH / 8), c = (i % (BH / 8)) * 8;
            cp_async16(w2s + r * ldg + c, w2 + (long long)r * a.hidden + s * BH + c);
        }
        cp_async_commit();
    };

    load_w1(0);
    layer_norm_rows<bf16>(a, row0, BM, xn, ldx);

    // step 1: warp (mt1, nt1) computes one 16 x 8 tile of the slab's hidden
    // activation; step 2: warp owns output columns [col0, col0 + F / 8)
    const int mt1 = warp >> 2, nt1 = warp & 3;
    const int nt_count = f / (8 * WARPS), col0 = warp * (f / WARPS);
    float acc[2][MAX_NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

    const bf16* arow = xn + (mt1 * 16 + g) * ldx + 2 * cq;
    const bf16* brow = w1s + (nt1 * 8 + g) * ldx + 2 * cq;
    for (int s = 0; s < slabs; ++s) {
        load_w2(s);
        cp_async_wait<1>();  // fc1 rows of slab s have landed
        __syncthreads();     // ... for every thread (and, at s = 0, the normalized rows)

        float h[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < f; k += 16) {
            const uint32_t af[4] = {ld_u32(arow + k), ld_u32(arow + 8 * ldx + k), ld_u32(arow + k + 8),
                                    ld_u32(arow + 8 * ldx + k + 8)};
            mma_16816(h, af, ld_u32(brow + k), ld_u32(brow + k + 8));
        }
        const int j = s * BH + nt1 * 8 + 2 * cq;
        const float b1a = to_f(b1[j]), b1b = to_f(b1[j + 1]);
        bf16* gp = gs + (mt1 * 16 + g) * ldg + nt1 * 8 + 2 * cq;
        *reinterpret_cast<uint32_t*>(gp) = pack_bf16(gelu_erf(h[0] + b1a), gelu_erf(h[1] + b1b));
        *reinterpret_cast<uint32_t*>(gp + 8 * ldg) = pack_bf16(gelu_erf(h[2] + b1a), gelu_erf(h[3] + b1b));
        __syncthreads();  // the slab's GELU output is complete; fc1 rows consumed

        if (s + 1 < slabs) {
            load_w1(s + 1);
            cp_async_wait<1>();  // fc2 columns of slab s have landed
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        uint32_t gf[2][2][4];  // A fragments: m tile, k step of 16
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                const bf16* p = gs + (mt * 16 + g) * ldg + kk * 16 + 2 * cq;
                gf[mt][kk][0] = ld_u32(p);
                gf[mt][kk][1] = ld_u32(p + 8 * ldg);
                gf[mt][kk][2] = ld_u32(p + 8);
                gf[mt][kk][3] = ld_u32(p + 8 * ldg + 8);
            }
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt) {
            if (nt < nt_count) {
                const bf16* bp = w2s + (col0 + nt * 8 + g) * ldg + 2 * cq;
#pragma unroll
                for (int kk = 0; kk < 2; ++kk) {
                    const uint32_t b0 = ld_u32(bp + kk * 16), b1v = ld_u32(bp + kk * 16 + 8);
                    mma_16816(acc[0][nt], gf[0][kk], b0, b1v);
                    mma_16816(acc[1][nt], gf[1][kk], b0, b1v);
                }
            }
        }
        __syncthreads();  // fc2 columns and GELU output consumed
    }

    const bf16* x = static_cast<const bf16*>(a.x);
    const bf16* b2 = static_cast<const bf16*>(a.b2);
    const bf16* ls = static_cast<const bf16*>(a.ls);
    bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = row0 + mt * 16 + g + 8 * half;
            if (row >= a.rows) continue;
            const long long base = (long long)row * f;
#pragma unroll
            for (int nt = 0; nt < MAX_NT; ++nt) {
                if (nt < nt_count) {
                    const int col = col0 + nt * 8 + 2 * cq;
                    const float y0 = fmaf(to_f(ls[col]), acc[mt][nt][2 * half] + to_f(b2[col]), to_f(x[base + col]));
                    const float y1 = fmaf(to_f(ls[col + 1]), acc[mt][nt][2 * half + 1] + to_f(b2[col + 1]), to_f(x[base + col + 1]));
                    *reinterpret_cast<uint32_t*>(out + base + col) = pack_bf16(y0, y1);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// float32: FMAs (the parity mode)
// ---------------------------------------------------------------------------

constexpr int F32_BM = 16;  // rows per CTA
constexpr int F32_BH = 16;  // hidden units per slab: F32_BM * F32_BH = THREADS fc1 outputs
constexpr int F32_PAD = 4;  // float row padding: 16-byte rows, conflict-free float4 loads
constexpr int F32_COLS = MAX_F / THREADS;  // fc2 output columns per thread at F = 1024

size_t f32_smem_bytes(int f) {
    return sizeof(float) * ((size_t)F32_BM * (f + F32_PAD) + (size_t)F32_BH * (f + F32_PAD) + (size_t)f * (F32_BH + F32_PAD) +
                            (size_t)F32_BM * (F32_BH + F32_PAD));
}

__global__ void __launch_bounds__(THREADS, 1) mlp_f32(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int f = a.f, ldx = f + F32_PAD, ldg = F32_BH + F32_PAD;
    float* xn = reinterpret_cast<float*>(smem);  // (BM, F)
    float* w1s = xn + F32_BM * ldx;              // (BH, F)
    float* w2s = w1s + F32_BH * ldx;             // (F, BH)
    float* gs = w2s + f * ldg;                   // (BM, BH)

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * F32_BM;
    const float* w1 = static_cast<const float*>(a.w1);
    const float* w2 = static_cast<const float*>(a.w2);
    const float* b1 = static_cast<const float*>(a.b1);
    const int slabs = a.hidden / F32_BH;

    auto load_w1 = [&](int s) {  // BH rows of F: F / 4 chunks of 16 B each
        const int per_row = f / 4;
        for (int i = tid; i < F32_BH * per_row; i += THREADS) {
            const int r = i / per_row, c = (i % per_row) * 4;
            cp_async16(w1s + r * ldx + c, w1 + (long long)(s * F32_BH + r) * f + c);
        }
        cp_async_commit();
    };
    auto load_w2 = [&](int s) {  // F rows of BH: 4 chunks of 16 B each
        for (int i = tid; i < f * (F32_BH / 4); i += THREADS) {
            const int r = i / (F32_BH / 4), c = (i % (F32_BH / 4)) * 4;
            cp_async16(w2s + r * ldg + c, w2 + (long long)r * a.hidden + s * F32_BH + c);
        }
        cp_async_commit();
    };

    load_w1(0);
    layer_norm_rows<float>(a, row0, F32_BM, xn, ldx);

    // fc1: this thread's (row r1, hidden unit j1) of the slab; fc2: columns tid + THREADS * i, all BM rows
    const int r1 = tid / F32_BH, j1 = tid % F32_BH;
    float acc[F32_COLS][F32_BM];
#pragma unroll
    for (int i = 0; i < F32_COLS; ++i)
#pragma unroll
        for (int r = 0; r < F32_BM; ++r) acc[i][r] = 0.f;

    for (int s = 0; s < slabs; ++s) {
        load_w2(s);
        cp_async_wait<1>();
        __syncthreads();

        const float4* xr = reinterpret_cast<const float4*>(xn + r1 * ldx);
        const float4* wr = reinterpret_cast<const float4*>(w1s + j1 * ldx);
        float h = 0.f;
        for (int k = 0; k < f / 4; ++k) {
            const float4 xv = xr[k], wv = wr[k];
            h = fmaf(xv.x, wv.x, h);
            h = fmaf(xv.y, wv.y, h);
            h = fmaf(xv.z, wv.z, h);
            h = fmaf(xv.w, wv.w, h);
        }
        gs[r1 * ldg + j1] = gelu_erf(h + b1[s * F32_BH + j1]);
        __syncthreads();

        if (s + 1 < slabs) {
            load_w1(s + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

#pragma unroll
        for (int kq = 0; kq < F32_BH / 4; ++kq) {
            float4 wv[F32_COLS];
#pragma unroll
            for (int i = 0; i < F32_COLS; ++i) {
                const int c = tid + THREADS * i;
                wv[i] = c < f ? *reinterpret_cast<const float4*>(w2s + c * ldg + 4 * kq) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int r = 0; r < F32_BM; ++r) {
                const float4 gv = *reinterpret_cast<const float4*>(gs + r * ldg + 4 * kq);
#pragma unroll
                for (int i = 0; i < F32_COLS; ++i) {
                    float t = acc[i][r];
                    t = fmaf(gv.x, wv[i].x, t);
                    t = fmaf(gv.y, wv[i].y, t);
                    t = fmaf(gv.z, wv[i].z, t);
                    acc[i][r] = fmaf(gv.w, wv[i].w, t);
                }
            }
        }
        __syncthreads();
    }

    const float* x = static_cast<const float*>(a.x);
    const float* b2 = static_cast<const float*>(a.b2);
    const float* ls = static_cast<const float*>(a.ls);
    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int i = 0; i < F32_COLS; ++i) {
        const int c = tid + THREADS * i;
        if (c >= f) continue;
        const float bias = b2[c], scale = ls[c];
#pragma unroll
        for (int r = 0; r < F32_BM; ++r) {
            const int row = row0 + r;
            if (row < a.rows) out[(long long)row * f + c] = fmaf(scale, acc[i][r] + bias, x[(long long)row * f + c]);
        }
    }
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_X = 0,     // (rows, F) tokens, rows contiguous
    SLOT_LN_W,      // (F,)
    SLOT_LN_B,      // (F,)
    SLOT_W1,        // (H, F)
    SLOT_B1,        // (H,)
    SLOT_W2,        // (F, H)
    SLOT_B2,        // (F,)
    SLOT_LS,        // (F,)
    SLOT_OUT,       // (rows, F)
    SLOT_ROWS,
    SLOT_FEATURES,  // F
    SLOT_HIDDEN,    // H
    SLOT_DTYPE,     // every tensor: 0 = float32, 1 = bfloat16
    SLOT_DEVICE,    // the CUDA device of every tensor
    NUM_SLOTS,
};

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot`. Every tensor is contiguous, in one dtype, 16-byte aligned
// (the caller checks). F is a multiple of 64 up to 1024; H a multiple of 32.
// The launch goes to args[SLOT_DEVICE]; the calling thread's current device
// is the same after the call as before. Returns the cudaError_t of the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int mdpt_fused_mlp(const long long* args, float eps, void* stream) {
    const long long rows = args[SLOT_ROWS];
    const int f = (int)args[SLOT_FEATURES], hidden = (int)args[SLOT_HIDDEN];
    const int dtype = (int)args[SLOT_DTYPE], device = (int)args[SLOT_DEVICE];
    if (rows < 1 || rows > (1LL << 30) || f < 64 || f > MAX_F || f % 64 != 0 || hidden < BH || hidden % BH != 0)
        return (int)cudaErrorInvalidValue;
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    for (int s = SLOT_X; s <= SLOT_OUT; ++s)
        if (args[s] == 0) return (int)cudaErrorInvalidValue;
    const Args a{reinterpret_cast<const void*>(args[SLOT_X]), reinterpret_cast<const void*>(args[SLOT_LN_W]),
                 reinterpret_cast<const void*>(args[SLOT_LN_B]), reinterpret_cast<const void*>(args[SLOT_W1]),
                 reinterpret_cast<const void*>(args[SLOT_B1]), reinterpret_cast<const void*>(args[SLOT_W2]),
                 reinterpret_cast<const void*>(args[SLOT_B2]), reinterpret_cast<const void*>(args[SLOT_LS]),
                 reinterpret_cast<void*>(args[SLOT_OUT]), (int)rows, f, hidden, eps};
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        const size_t bytes = bf16_smem_bytes(f);
        err = cudaFuncSetAttribute(mlp_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err == cudaSuccess) {
            mlp_bf16<<<(unsigned)((rows + BM - 1) / BM), THREADS, bytes, s>>>(a);
            err = cudaGetLastError();
        }
    } else {
        const size_t bytes = f32_smem_bytes(f);
        err = cudaFuncSetAttribute(mlp_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err == cudaSuccess) {
            mlp_f32<<<(unsigned)((rows + F32_BM - 1) / F32_BM), THREADS, bytes, s>>>(a);
            err = cudaGetLastError();
        }
    }
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
