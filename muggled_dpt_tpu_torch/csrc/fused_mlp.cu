// Fused LayerNorm -> fc1 -> GELU -> fc2 -> LayerScale residual for Hopper
// (sm_90a), the C entry and the float32 kernel: the second half of a
// pre-norm transformer block with a GELU MLP,
//   out = x + ls * (fc2(gelu(fc1(layer_norm(x)))))
// on (rows, F) tokens, with torch-layout weights fc1 (H, F) and fc2 (F, H).
//
// Replaces TPU kernel #8: experiments/pallas_fused_mlp.py:fused_ln_mlp_residual
// (_kernel, :59). The C entry sends every bfloat16 launch to the three
// kernels of fused_mlp_sm90.cu (a LayerNorm pass, then fc1 with the GELU
// and fc2 with the LayerScale residual as wgmma/TMA GEMMs, the hidden
// activation through the wrapper's scratch) and reports the route it took
// in SLOT_ROUTE; float32 (the parity mode) runs mlp_f32 below. Both keep
// the TPU kernel's rounding points: LayerNorm statistics and affine step in
// f32, the normalized rows rounded to x's type; fc1 summed in f32 plus b1;
// exact (erf) GELU in f32 (the TPU kernel's polynomial erf was a Mosaic
// workaround), rounded to x's type; fc2 summed in f32 plus b2, times ls,
// plus the f32 residual; one rounding at the end.
//
// mlp_f32: one CTA per 16 rows. The normalized rows stay in shared memory
// for the whole CTA; the hidden width is walked in slabs of 16 units, and
// each slab's fc1 rows and fc2 columns stream through shared memory with
// cp.async, the fc2 columns of slab s loading while slab s's fc1 product
// runs and slab s+1's fc1 rows loading while slab s's fc2 product runs. The
// (16, F) f32 accumulator of fc2 lives in registers, spread over the threads
// by output column, so neither the (rows, H) hidden activation nor the
// accumulator reaches global memory. It runs on plain FMAs, since TF32
// would not hold float32 accuracy: bound by the f32 rate (67 TFLOP/s, 2.6
// ms for ViT-L's 174 GFLOP at B = 8) and by every CTA streaming all the
// weights from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// one warp per row. Rows past the end are zero.
__device__ void layer_norm_rows(const Args& a, int row0, int bm, float* xn, int ld) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float* g = static_cast<const float*>(a.ln_w);
    const float* bb = static_cast<const float*>(a.ln_b);
    for (int r = warp; r < bm; r += WARPS) {
        const int row = row0 + r;
        float* dst = xn + r * ld;
        if (row >= a.rows) {
            for (int c = lane; c < a.f; c += 32) dst[c] = 0.f;
            continue;
        }
        const float* src = static_cast<const float*>(a.x) + (long long)row * a.f;
        float s = 0.f;
        for (int c = lane; c < a.f; c += 32) s += src[c];
        const float mean = warp_sum(s) / a.f;
        float v = 0.f;
        for (int c = lane; c < a.f; c += 32) {
            const float d = src[c] - mean;
            v = fmaf(d, d, v);
        }
        const float rstd = rsqrtf(warp_sum(v) / a.f + a.eps);
        for (int c = lane; c < a.f; c += 32) dst[c] = (src[c] - mean) * rstd * g[c] + bb[c];
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
    layer_norm_rows(a, row0, F32_BM, xn, ldx);

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
    SLOT_XN,        // bfloat16: the (rows, F) scratch of the normalized rows; float32: 0
    SLOT_GELU,      // bfloat16: the (rows, H) scratch of the GELU output; float32: 0
    SLOT_EVENTS,    // 0, or the address of four cudaEvent_t the sm_90 route records around its kernels
    SLOT_ROUTE,     // written by the call: ROUTE_SM90 or ROUTE_FMA, the kernels that ran
    NUM_SLOTS,
};

constexpr long long ROUTE_FMA = 0, ROUTE_SM90 = 1;
constexpr int HIDDEN_STEP = 32;  // H must be a multiple (the f32 kernel's slab takes 16, the sm_90 GEMMs 8)

// Whether fused_mlp_sm90.cu takes the launch: every bfloat16 one.
bool sm90_takes(const long long* args) { return args[SLOT_DTYPE] == 1; }

}  // namespace

// fused_mlp_sm90.cu: the bfloat16 launches
cudaError_t fused_mlp_sm90(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* ls, void* out, void* xn, void* g, int rows, int f, int hidden, float eps,
                           void* const* events, cudaStream_t stream);

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot`. Every tensor is contiguous, in one dtype, 16-byte aligned
// (the caller checks). F is a multiple of 64 up to 1024; H a multiple of 32.
// The launch goes to args[SLOT_DEVICE]; the calling thread's current device
// is the same after the call as before. The call writes the route it took
// to args[SLOT_ROUTE]. Returns the cudaError_t of the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int mdpt_fused_mlp(long long* args, float eps, void* stream) {
    const long long rows = args[SLOT_ROWS];
    const int f = (int)args[SLOT_FEATURES], hidden = (int)args[SLOT_HIDDEN];
    const int dtype = (int)args[SLOT_DTYPE], device = (int)args[SLOT_DEVICE];
    if (rows < 1 || rows > (1LL << 30) || f < 64 || f > MAX_F || f % 64 != 0 || hidden < HIDDEN_STEP || hidden % HIDDEN_STEP != 0)
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
    const bool sm90 = sm90_takes(args);
    args[SLOT_ROUTE] = sm90 ? ROUTE_SM90 : ROUTE_FMA;
    if (sm90) {
        err = fused_mlp_sm90(a.x, a.ln_w, a.ln_b, a.w1, a.b1, a.w2, a.b2, a.ls, a.out, reinterpret_cast<void*>(args[SLOT_XN]),
                             reinterpret_cast<void*>(args[SLOT_GELU]), a.rows, f, hidden, eps,
                             reinterpret_cast<void* const*>(args[SLOT_EVENTS]), s);
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
