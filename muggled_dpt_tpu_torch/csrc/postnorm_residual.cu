// SwinV2's post-norm residual for Hopper (sm_90a), float32, bfloat16 and
// float16, in one pass. Per output token row (b, i, j) of C channels:
//   y   = g(h)[b, i, j]                        (h's row in window order, below)
//   ln  = LayerNorm(y) * weight + bias         (statistics over C, eps 1e-5)
//   out = x[b, i, j] + ln
// with x the block's contiguous (B, H, W, C) residual stream. For the
// attention half h is proj's (B, nW, A, C) output in window order, and g
// undoes the window partition and the cyclic roll of the shifted blocks:
//   i' = (i - sh) mod H,  j' = (j - sw) mod W
//   w  = (i' / wh) * (W / ww) + j' / ww,  a = (i' mod wh) * ww + j' mod ww
// so row (b, i, j) reads h's row (b, w, a). For the MLP half (and for a
// stage whose grid is one window and does not shift) g is the identity.
// The arithmetic is the composite's (models/swinv2.py: merge_windows,
// torch.roll, F.layer_norm, the add): the mean and the biased variance in
// float32 from the stored h, ln = weight * (rstd * (y - mean)) + bias in
// float32 from the weight and bias converted exactly, ln rounded to the
// tokens' type as F.layer_norm returns it, then x + ln in float32 rounded
// once, as torch's 16-bit add does. The statistics' sums are the one
// reordering: torch runs Welford, this kernel two passes over registers.
//
// It replaces no Pallas kernel: the JAX package leaves the post-norm to XLA
// (muggled_dpt_tpu/models/swinv2.py:268 and :272), which fuses it on the TPU.
// On the H100 PyTorch ran it as a LayerNorm and an add a half-block, and on
// the shifted stages a strided merge copy and two roll launches before them.
// The work is a few flops per byte: its bound is bytes, h and x read once
// and out written once, 6 bytes an element in bf16 (5.27 GB a SwinV2-L-384
// step at B=32, 384x384: 1.57 ms at 3.35 TB/s).
//
// Design: a group of LANES threads owns a row and holds its C channels in
// registers, CHUNKS 16-byte vectors a thread, the vectors of a row dealt to
// the lanes in turn so that each load and store of a group covers
// consecutive 16-byte pieces of one row, gathered or not. Every load of a
// row (h and x) is issued before the first reduction, with the evict-first
// hint (each byte is read once); the mean and the variance are summed
// pairwise in registers, then across the group with __shfl_xor_sync. The
// host picks the group that holds the row in three vectors a thread: in bf16
// 8 lanes at C 192, 16 at 384 (four and two rows a warp), a warp at 768;
// at 1536 a warp with six vectors a thread. So a thread holds 24 elements
// in about 62 registers, and 256-thread blocks keep 32 warps an SM with
// their rows' loads in flight; the window and roll index is integer
// arithmetic on the row number: no index tensor, no extra bytes. Measured
// against six vectors a thread (two to eight lanes fewer, about 119
// registers) and plain loads, at SwinV2-L-384's shapes on an H100.
// Its times on an H100 against the byte floor are in PERF.md's kernel table.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr float EPS = 1e-5f;  // SwinV2's LayerNorm eps (models/swinv2.py: SWIN_LN_EPS)

struct PostnormArgs {
    const void* x;
    const void* h;
    const void* weight;
    const void* bias;
    void* out;
    unsigned grid_h, grid_w, windows_w, win_h, win_w, shift_h, shift_w, area, windows;
    unsigned channels, vectors, rows;  // vectors: 16-byte vectors a row
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

template <typename T>
struct alignas(16) Vec {
    static constexpr int N = 16 / sizeof(T);
    T v[N];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_stream(const T* p) {  // read once: evict first
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Vec<T>*>(&raw);
}

template <int LANES>
__device__ __forceinline__ float group_sum(float s, unsigned mask) {
#pragma unroll
    for (int m = 1; m < LANES; m <<= 1) s = __fadd_rn(s, __shfl_xor_sync(mask, s, m));
    return s;
}

// Pairwise sum of K values: short dependency chains.
template <int K>
__device__ __forceinline__ float pairwise(const float* v) {
    if constexpr (K == 1) {
        return v[0];
    } else {
        return __fadd_rn(pairwise<K / 2>(v), pairwise<K - K / 2>(v + K / 2));
    }
}

// EXACT: the row is LANES * CHUNKS vectors, every one present; otherwise
// vectors past the row's end are skipped (zeros in the sums).
template <typename T, int LANES, int CHUNKS, bool EXACT>
__global__ void __launch_bounds__(THREADS) postnorm_residual_sm90(const PostnormArgs a) {
    constexpr int N = Vec<T>::N;
    const int lane = threadIdx.x % LANES;
    const unsigned mask = LANES == 32 ? 0xFFFFFFFFu : ((1u << LANES) - 1) << (threadIdx.x & 31 & ~(LANES - 1));
    const unsigned row = blockIdx.x * (THREADS / LANES) + threadIdx.x / LANES;
    if (row >= a.rows) return;  // a whole group leaves together: the shuffles' lanes stay in step
    // the output row (b, i, j) and the window-order row of h it reads
    const unsigned j = row % a.grid_w, bi = row / a.grid_w;
    const unsigned i = bi % a.grid_h, b = bi / a.grid_h;
    const unsigned si = i >= a.shift_h ? i - a.shift_h : i + a.grid_h - a.shift_h;
    const unsigned sj = j >= a.shift_w ? j - a.shift_w : j + a.grid_w - a.shift_w;
    const unsigned w = (si / a.win_h) * a.windows_w + sj / a.win_w;
    const unsigned src = (b * a.windows + w) * a.area + (si % a.win_h) * a.win_w + sj % a.win_w;
    const T* h = static_cast<const T*>(a.h) + (size_t)src * a.channels;
    const T* x = static_cast<const T*>(a.x) + (size_t)row * a.channels;
    auto present = [&](int c) { return EXACT || c * LANES + lane < (int)a.vectors; };

    float y[CHUNKS][N], part[CHUNKS];
    Vec<T> xv[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        const int v = c * LANES + lane;
        if (present(c)) {
            const Vec<T> hv = load_stream(h + v * N);
            xv[c] = load_stream(x + v * N);
#pragma unroll
            for (int e = 0; e < N; ++e) y[c][e] = to_f(hv.v[e]);
        } else {
#pragma unroll
            for (int e = 0; e < N; ++e) y[c][e] = 0.f;
        }
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) part[c] = pairwise<N>(y[c]);
    const float mean = __fdiv_rn(group_sum<LANES>(pairwise<CHUNKS>(part), mask), (float)a.channels);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        float d[N];
#pragma unroll
        for (int e = 0; e < N; ++e) {
            const float t = __fsub_rn(y[c][e], mean);
            d[e] = __fmul_rn(t, t);
        }
        part[c] = present(c) ? pairwise<N>(d) : 0.f;
    }
    const float var = __fdiv_rn(group_sum<LANES>(pairwise<CHUNKS>(part), mask), (float)a.channels);
    const float rstd = rsqrtf(__fadd_rn(var, EPS));
    const T* weight = static_cast<const T*>(a.weight);
    const T* bias = static_cast<const T*>(a.bias);
    T* out = static_cast<T*>(a.out) + (size_t)row * a.channels;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        if (!present(c)) continue;
        const int v = c * LANES + lane;
        const Vec<T> gv = *reinterpret_cast<const Vec<T>*>(weight + v * N);
        const Vec<T> bv = *reinterpret_cast<const Vec<T>*>(bias + v * N);
        Vec<T> ov;
#pragma unroll
        for (int e = 0; e < N; ++e) {
            const float ln = __fmaf_rn(to_f(gv.v[e]), __fmul_rn(rstd, __fsub_rn(y[c][e], mean)), to_f(bv.v[e]));
            ov.v[e] = from_f<T>(__fadd_rn(to_f(xv[c].v[e]), to_f(from_f<T>(ln))));
        }
        *reinterpret_cast<Vec<T>*>(out + v * N) = ov;
    }
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_X = 0,     // (B, H, W, C) contiguous residual stream
    SLOT_H,         // contiguous (B, nW, A, C) in window order, or (B, H, W, C) with no window
    SLOT_WEIGHT,    // (C,) contiguous LayerNorm weight in the tokens' dtype
    SLOT_BIAS,      // (C,) contiguous LayerNorm bias in the tokens' dtype
    SLOT_OUT,       // (B, H, W, C) contiguous output
    SLOT_BATCH,
    SLOT_GRID_H,
    SLOT_GRID_W,
    SLOT_CHANNELS,
    SLOT_WINDOW_H,  // the window h is in; the grid itself where h is in token order
    SLOT_WINDOW_W,
    SLOT_SHIFT_H,   // the roll to undo, 0 <= shift < grid
    SLOT_SHIFT_W,
    SLOT_DTYPE,     // 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_DEVICE,    // the CUDA device of every tensor
    NUM_SLOTS,
};

constexpr int CHUNKS = 3;       // 16-byte vectors a thread where the row is a whole number of them per lane
constexpr int MAX_VECTORS = 384;  // the widest row: 32 lanes of 12 vectors (1536 float32 or 3072 16-bit channels)

template <typename T, int LANES, int K>
cudaError_t launch_group(const PostnormArgs& a, cudaStream_t s) {
    postnorm_residual_sm90<T, LANES, K, true><<<(a.rows + THREADS / LANES - 1) / (THREADS / LANES), THREADS, 0, s>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const PostnormArgs& a, cudaStream_t s) {
    // a row of CHUNKS vectors a lane over 4 to 32 lanes (in 16-bit types SwinV2's 96 to 768 channels), 6 or 12
    // a lane over a warp; any other row width through the general instance, which skips the vectors past its end
    switch (a.vectors) {
        case 4 * CHUNKS: return launch_group<T, 4, CHUNKS>(a, s);
        case 8 * CHUNKS: return launch_group<T, 8, CHUNKS>(a, s);
        case 16 * CHUNKS: return launch_group<T, 16, CHUNKS>(a, s);
        case 32 * CHUNKS: return launch_group<T, 32, CHUNKS>(a, s);
        case 32 * 6: return launch_group<T, 32, 6>(a, s);
        case 32 * 12: return launch_group<T, 32, 12>(a, s);
        default:
            postnorm_residual_sm90<T, 32, MAX_VECTORS / 32, false><<<(a.rows + THREADS / 32 - 1) / (THREADS / 32), THREADS,
                                                                    0, s>>>(a);
            return cudaGetLastError();
    }
}

bool aligned(long long p) { return p != 0 && p % 16 == 0; }

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid out
// as in `Slot`. The launch goes to args[SLOT_DEVICE]; the calling thread's
// current device is the same after the call as before. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int mdpt_postnorm_residual(const long long* args, void* stream) {
    const long long batch = args[SLOT_BATCH], gh = args[SLOT_GRID_H], gw = args[SLOT_GRID_W], c = args[SLOT_CHANNELS];
    const long long wh = args[SLOT_WINDOW_H], ww = args[SLOT_WINDOW_W], sh = args[SLOT_SHIFT_H], sw = args[SLOT_SHIFT_W];
    const long long dtype = args[SLOT_DTYPE], device = args[SLOT_DEVICE];
    const int elem = dtype == 0 ? 4 : 2;
    if (dtype < 0 || dtype > 2 || batch < 1 || gh < 1 || gw < 1 || c < 1 || c * elem % 16 != 0 ||
        c * elem / 16 > MAX_VECTORS || wh < 1 || ww < 1 || gh % wh != 0 || gw % ww != 0 || sh < 0 || sh >= gh ||
        sw < 0 || sw >= gw || batch * gh * gw >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    for (int slot = SLOT_X; slot <= SLOT_OUT; ++slot)
        if (!aligned(args[slot])) return (int)cudaErrorInvalidValue;
    PostnormArgs a{reinterpret_cast<const void*>(args[SLOT_X]), reinterpret_cast<const void*>(args[SLOT_H]),
                   reinterpret_cast<const void*>(args[SLOT_WEIGHT]), reinterpret_cast<const void*>(args[SLOT_BIAS]),
                   reinterpret_cast<void*>(args[SLOT_OUT]), (unsigned)gh, (unsigned)gw, (unsigned)(gw / ww),
                   (unsigned)wh, (unsigned)ww, (unsigned)sh, (unsigned)sw, (unsigned)(wh * ww),
                   (unsigned)((gh / wh) * (gw / ww)), (unsigned)c, (unsigned)(c * elem / 16),
                   (unsigned)(batch * gh * gw)};
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice((int)device);
    if (err == cudaSuccess) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (dtype == 0) {
            err = launch<float>(a, s);
        } else if (dtype == 1) {
            err = launch<bf16>(a, s);
        } else {
            err = launch<__half>(a, s);
        }
    }
    if (current >= 0 && current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
