// Fused depth-head tail for Hopper (sm_90a), float32 and bfloat16: per pixel
//   t[o] = relu(conv_b[o] + sum_{c, dy, dx} conv_w[o, c, dy, dx] * x[c, y + dy - 1, x + dx - 1])   (o < 32)
//   out  = act(proj_b + sum_o proj_w[o] * t[o]),  act = ReLU, or sigmoid for a metric head
// on an NCHW (B, ci, H, W) map with zero padding 1, giving (B, H, W).
//
// Replaces TPU kernel #9: experiments/pallas_head_conv.py:fused_head_tail
// (_kernel, :52). The TPU kernel takes one NHWC image and pads it in HBM; this
// one takes the batch the head runs, reads the NCHW map where it lies and
// does the halo at the image borders by index (no padded copy). Its rounding
// points are kept: the conv summed in f32 plus the bias, ReLU, the 32 -> 1
// projection in f32 plus its bias, the activation, one rounding. The
// (B, 32, H, W) map of the 3x3 conv never reaches global memory.
//
// Design: one CTA per 16 x 16 output tile of one image, 128 threads, each
// computing two vertically adjacent pixels with 32 f32 accumulators apiece.
// Input channels are walked in stages of 16: each stage's 18 x 18 halo tile
// (zero outside the image) and its 16 * 9 * 32 weights are copied into shared
// memory as f32, and every thread sums 2 * 32 products per (channel, tap).
// Ragged tiles (W = 504 is no multiple of 16) are masked by index.
//
// Bounds on an H100 at ci = 128, 504 x 504, one image: 2 * H * W * 32 * 9 * ci
// = 18.7 GFLOP against 65 MB of bf16 input: 19-20 us at 989 TFLOP/s and
// 3.35 TB/s (the tensor cores and HBM about even). This simple kernel runs on
// the FP32 pipes (67 TFLOP/s, 0.28 ms per image) in both dtypes, so its bf16
// path is bound by operations at the f32 rate. Left for later: the bf16 path
// as an implicit GEMM on the tensor cores (M = pixels, N = 32, K = 9 * ci),
// with cp.async double buffering of the halo tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CO = 32;        // conv output channels: every DPT head's 3x3 conv -> 32
constexpr int TW = 16;        // output tile width
constexpr int TH = 16;        // output tile height
constexpr int THREADS = 128;  // two pixels (rows ty, ty + 1) per thread
constexpr int CC = 16;        // input channels per shared-memory stage
constexpr int HALO_W = 24;    // halo row (18 used): the two row groups of a warp fall on disjoint banks

struct Args {
    const void* x;       // (B, ci, H, W)
    const void* conv_w;  // (32, ci, 3, 3)
    const void* conv_b;  // (32,)
    const void* proj_w;  // (32,)
    const void* proj_b;  // (1,)
    void* out;           // (B, H, W)
    int ci, h, w, is_metric;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) head_tail(const Args a) {
    __shared__ float xs[CC][TH + 2][HALO_W];       // halo tile of CC channels
    __shared__ __align__(16) float ws[CC * 9][CO];  // weights of those channels: [channel * 9 + tap][out channel]

    const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const int tid = threadIdx.x, tx = tid % TW, ty = (tid / TW) * 2;
    const int ci = a.ci, h = a.h, w = a.w;
    const long long plane = (long long)h * w;
    const T* xb = static_cast<const T*>(a.x) + (long long)b * ci * plane;
    const T* wt = static_cast<const T*>(a.conv_w);

    float acc[2][CO];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[p][o] = 0.f;

    for (int c0 = 0; c0 < ci; c0 += CC) {
        const int cn = min(CC, ci - c0);
        __syncthreads();  // the previous stage has been consumed
        for (int i = tid; i < CC * (TH + 2) * (TW + 2); i += THREADS) {
            const int c = i / ((TH + 2) * (TW + 2)), rem = i % ((TH + 2) * (TW + 2));
            const int hy = rem / (TW + 2), hx = rem % (TW + 2);
            const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
            float v = 0.f;
            if (c < cn && gy >= 0 && gy < h && gx >= 0 && gx < w) v = to_f(xb[(c0 + c) * plane + (long long)gy * w + gx]);
            xs[c][hy][hx] = v;
        }
        for (int i = tid; i < CC * 9 * CO; i += THREADS) {  // out channel fastest: conflict-free shared stores
            const int o = i % CO, ct = i / CO, c = ct / 9;
            ws[ct][o] = c < cn ? to_f(wt[((long long)o * ci + c0) * 9 + ct]) : 0.f;
        }
        __syncthreads();

#pragma unroll 1
        for (int c = 0; c < CC; ++c) {
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                const int dy = tap / 3, dx = tap % 3;
                const float v0 = xs[c][ty + dy][tx + dx], v1 = xs[c][ty + 1 + dy][tx + dx];
                const float4* wr = reinterpret_cast<const float4*>(ws[c * 9 + tap]);
#pragma unroll
                for (int q = 0; q < CO / 4; ++q) {
                    const float4 wv = wr[q];
                    acc[0][4 * q] = fmaf(v0, wv.x, acc[0][4 * q]);
                    acc[0][4 * q + 1] = fmaf(v0, wv.y, acc[0][4 * q + 1]);
                    acc[0][4 * q + 2] = fmaf(v0, wv.z, acc[0][4 * q + 2]);
                    acc[0][4 * q + 3] = fmaf(v0, wv.w, acc[0][4 * q + 3]);
                    acc[1][4 * q] = fmaf(v1, wv.x, acc[1][4 * q]);
                    acc[1][4 * q + 1] = fmaf(v1, wv.y, acc[1][4 * q + 1]);
                    acc[1][4 * q + 2] = fmaf(v1, wv.z, acc[1][4 * q + 2]);
                    acc[1][4 * q + 3] = fmaf(v1, wv.w, acc[1][4 * q + 3]);
                }
            }
        }
    }

    const T* cb = static_cast<const T*>(a.conv_b);
    const T* pw = static_cast<const T*>(a.proj_w);
    const float pb = to_f(static_cast<const T*>(a.proj_b)[0]);
    T* out = static_cast<T*>(a.out) + (long long)b * plane;
    const int gx = x0 + tx;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const int gy = y0 + ty + p;
        if (gy >= h || gx >= w) continue;
        float s = pb;
#pragma unroll
        for (int o = 0; o < CO; ++o) s = fmaf(to_f(pw[o]), fmaxf(acc[p][o] + to_f(cb[o]), 0.f), s);
        s = a.is_metric ? 1.f / (1.f + expf(-s)) : fmaxf(s, 0.f);
        out[(long long)gy * w + gx] = from_f<T>(s);
    }
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_X = 0,      // (B, ci, H, W), contiguous
    SLOT_CONV_W,     // (32, ci, 3, 3), contiguous
    SLOT_CONV_B,     // (32,)
    SLOT_PROJ_W,     // (32,): the (1, 32, 1, 1) projection
    SLOT_PROJ_B,     // (1,)
    SLOT_OUT,        // (B, H, W)
    SLOT_BATCH,
    SLOT_CHANNELS,   // ci
    SLOT_HEIGHT,
    SLOT_WIDTH,
    SLOT_OUT_CHANNELS,  // must be 32
    SLOT_IS_METRIC,     // 1: sigmoid, 0: ReLU
    SLOT_DTYPE,         // every tensor: 0 = float32, 1 = bfloat16
    SLOT_DEVICE,        // the CUDA device of every tensor
    NUM_SLOTS,
};

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot`. Every tensor is contiguous and in one dtype (the caller
// checks). The launch goes to args[SLOT_DEVICE]; the calling thread's current
// device is the same after the call as before. Returns the cudaError_t of the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int mdpt_head_tail(const long long* args, void* stream) {
    const long long batch = args[SLOT_BATCH], ci = args[SLOT_CHANNELS], h = args[SLOT_HEIGHT], w = args[SLOT_WIDTH];
    const int dtype = (int)args[SLOT_DTYPE], device = (int)args[SLOT_DEVICE];
    if (batch < 1 || batch > 65535 || ci < 1 || h < 1 || w < 1 || args[SLOT_OUT_CHANNELS] != CO)
        return (int)cudaErrorInvalidValue;
    if ((h + TH - 1) / TH > 65535 || ci * h * w > (1LL << 40) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    for (int s = SLOT_X; s <= SLOT_OUT; ++s)
        if (args[s] == 0) return (int)cudaErrorInvalidValue;
    const Args a{reinterpret_cast<const void*>(args[SLOT_X]),      reinterpret_cast<const void*>(args[SLOT_CONV_W]),
                 reinterpret_cast<const void*>(args[SLOT_CONV_B]), reinterpret_cast<const void*>(args[SLOT_PROJ_W]),
                 reinterpret_cast<const void*>(args[SLOT_PROJ_B]), reinterpret_cast<void*>(args[SLOT_OUT]),
                 (int)ci, (int)h, (int)w, args[SLOT_IS_METRIC] != 0};
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((w + TW - 1) / TW), (unsigned)((h + TH - 1) / TH), (unsigned)batch);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        head_tail<bf16><<<grid, THREADS, 0, s>>>(a);
    } else {
        head_tail<float><<<grid, THREADS, 0, s>>>(a);
    }
    err = cudaGetLastError();
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
