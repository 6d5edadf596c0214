// SwinV2's cosine normalization of q and k for Hopper (sm_90a), float32,
// bfloat16 and float16, in one pass over the qkv projection's output. Per
// (batch, window, row, head), over the head dim's D = 32 elements x:
//   s = sum x^2,  r = rsqrt(s + 1e-12)
//   qs = (x_q * r_q) * scale[h]   (the block's logit scale, folded into q)
//   kn = x_k * r_k
// in float32, each product rounded as the composite rounds it
// (models/swinv2.py: cosine_normalize, then the scale fold and the casts),
// each output rounded once to q's type. The sum is the one reordering: four
// lanes' partial sums of eight squares, then two butterfly steps.
//
// It replaces no Pallas kernel: the JAX package leaves this to XLA, which
// fuses it into the surrounding ops on the TPU. On the H100 PyTorch ran it as
// some 13 launches a block (a strided copy to float32, the square, a sum over
// the 32-wide axis, the epsilon, rsqrt, the multiplies, the casts), about 40
// bytes of device memory moved per q element. The work is a few flops per
// byte, far below the ridge: its bound is bytes, q and k read once in their
// type and qs and kn written once, 8 bytes per q element in bf16 (3.5 GB a
// SwinV2-L-384 step at B=32, 384x384: 1.05 ms at 3.35 TB/s).
//
// Design: four threads own a (token, head) row, eight elements each: one
// 16-byte load of q and one of k a thread in 16-bit types (two of each in
// float32), the squares summed in registers, then across the four lanes with
// two __shfl_xor_sync steps, and 16-byte stores of the outputs. q and k are
// the strided (B, nW, A, H, 32) views of the qkv output, read in place by
// their (batch, window, row, head) strides; the outputs are contiguous
// (B, nW, A, H, 32), the layout window attention #3 reads. The grid holds
// one four-lane group a row. The logit scale is read in q's type (the model
// holds it so) and converted exactly, as the composite's .float() does.
// Its times on an H100 against the byte floor are in PERF.md's kernel table.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 32;                         // SwinV2's head dim: F / H = 32 in every configuration
constexpr int LANES = 4;                      // threads a row
constexpr int PER_LANE = D / LANES;           // elements a thread
constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / LANES;
constexpr float EPS = 1e-12f;

struct CosineArgs {
    const void* q;
    const void* k;
    const void* scale;
    void* qs;
    void* kn;
    unsigned long long q_stride[4], k_stride[4];  // (batch, window, row, head) element strides
    unsigned windows, area, heads, rows;
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

// A thread's eight elements: 16 bytes in a 16-bit type, two 16-byte halves in float32.
template <typename T>
struct alignas(16) Part {
    T v[PER_LANE];
};

// Squares rounded one by one (the composite's x * x), summed in float32.
__device__ __forceinline__ float sum_squares(const float (&x)[PER_LANE]) {
    float s = __fmul_rn(x[0], x[0]);
#pragma unroll
    for (int i = 1; i < PER_LANE; ++i) s = __fadd_rn(s, __fmul_rn(x[i], x[i]));
    return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) cosine_qk_sm90(const CosineArgs a) {
    const int lane = threadIdx.x % LANES;
    const unsigned quad = 0xFu << (threadIdx.x & 28);  // the row's four lanes in the warp
    const unsigned row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / LANES;
    if (row >= a.rows) return;  // a whole group leaves together: the shuffles' lanes stay in step
    const unsigned h = row % a.heads, token = row / a.heads;
    const unsigned i = token % a.area, bw = token / a.area;
    const unsigned w = bw % a.windows, b = bw / a.windows;
    const T* q = static_cast<const T*>(a.q) + b * a.q_stride[0] + w * a.q_stride[1] + i * a.q_stride[2] +
                 h * a.q_stride[3] + lane * PER_LANE;
    const T* k = static_cast<const T*>(a.k) + b * a.k_stride[0] + w * a.k_stride[1] + i * a.k_stride[2] +
                 h * a.k_stride[3] + lane * PER_LANE;
    const Part<T> pq = *reinterpret_cast<const Part<T>*>(q);
    const Part<T> pk = *reinterpret_cast<const Part<T>*>(k);
    const float scale = to_f(static_cast<const T*>(a.scale)[h]);
    float xq[PER_LANE], xk[PER_LANE];
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) xq[e] = to_f(pq.v[e]), xk[e] = to_f(pk.v[e]);
    float sq = sum_squares(xq), sk = sum_squares(xk);
#pragma unroll
    for (int m = 1; m < LANES; m <<= 1) {
        sq = __fadd_rn(sq, __shfl_xor_sync(quad, sq, m));
        sk = __fadd_rn(sk, __shfl_xor_sync(quad, sk, m));
    }
    const float rq = rsqrtf(__fadd_rn(sq, EPS)), rk = rsqrtf(__fadd_rn(sk, EPS));
    Part<T> oq, ok;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
        oq.v[e] = from_f<T>(__fmul_rn(__fmul_rn(xq[e], rq), scale));
        ok.v[e] = from_f<T>(__fmul_rn(xk[e], rk));
    }
    const size_t out = (size_t)row * D + lane * PER_LANE;
    *reinterpret_cast<Part<T>*>(static_cast<T*>(a.qs) + out) = oq;
    *reinterpret_cast<Part<T>*>(static_cast<T*>(a.kn) + out) = ok;
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_Q = 0,       // (B, nW, A, H, 32) q, the head dim contiguous
    SLOT_Q_STRIDE_B,  // its element strides
    SLOT_Q_STRIDE_W,
    SLOT_Q_STRIDE_A,
    SLOT_Q_STRIDE_H,
    SLOT_K,           // k, of q's shape and dtype
    SLOT_K_STRIDE_B,
    SLOT_K_STRIDE_W,
    SLOT_K_STRIDE_A,
    SLOT_K_STRIDE_H,
    SLOT_SCALE,       // (H,) contiguous logit scale in q's dtype
    SLOT_QS,          // (B, nW, A, H, 32) contiguous outputs in q's dtype
    SLOT_KN,
    SLOT_BATCH,
    SLOT_WINDOWS,
    SLOT_AREA,
    SLOT_HEADS,
    SLOT_HEAD_DIM,
    SLOT_DTYPE,       // 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_DEVICE,      // the CUDA device of every tensor
    NUM_SLOTS,
};

template <typename T>
void launch(const CosineArgs& a, cudaStream_t s) {
    cosine_qk_sm90<T><<<(a.rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, THREADS, 0, s>>>(a);
}

// Each pointer and every stride of a vector access is a multiple of 16 bytes.
bool aligned(const long long* t, int elem) {
    for (int d = 1; d < 5; ++d)
        if (t[d] * elem % 16 != 0) return false;
    return t[0] != 0 && t[0] % 16 == 0;
}

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid out
// as in `Slot`. The launch goes to args[SLOT_DEVICE]; the calling thread's
// current device is the same after the call as before. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int mdpt_cosine_qk(const long long* args, void* stream) {
    const long long batch = args[SLOT_BATCH], windows = args[SLOT_WINDOWS], area = args[SLOT_AREA];
    const long long heads = args[SLOT_HEADS], dtype = args[SLOT_DTYPE], device = args[SLOT_DEVICE];
    const int elem = dtype == 0 ? 4 : 2;
    if (args[SLOT_HEAD_DIM] != D || batch < 1 || windows < 1 || area < 1 || heads < 1 || dtype < 0 || dtype > 2 ||
        batch * windows * area * heads >= (1LL << 31) || args[SLOT_SCALE] == 0)
        return (int)cudaErrorInvalidValue;
    if (!aligned(args + SLOT_Q, elem) || !aligned(args + SLOT_K, elem) || args[SLOT_QS] == 0 || args[SLOT_QS] % 16 != 0 ||
        args[SLOT_KN] == 0 || args[SLOT_KN] % 16 != 0)
        return (int)cudaErrorInvalidValue;
    CosineArgs a{reinterpret_cast<const void*>(args[SLOT_Q]), reinterpret_cast<const void*>(args[SLOT_K]),
                 reinterpret_cast<const void*>(args[SLOT_SCALE]), reinterpret_cast<void*>(args[SLOT_QS]),
                 reinterpret_cast<void*>(args[SLOT_KN]), {}, {}, (unsigned)windows, (unsigned)area, (unsigned)heads,
                 (unsigned)(batch * windows * area * heads)};
    for (int d = 0; d < 4; ++d) {
        a.q_stride[d] = (unsigned long long)args[SLOT_Q + 1 + d];
        a.k_stride[d] = (unsigned long long)args[SLOT_K + 1 + d];
    }
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice((int)device);
    if (err == cudaSuccess) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (dtype == 0) {
            launch<float>(a, s);
        } else if (dtype == 1) {
            launch<bf16>(a, s);
        } else {
            launch<__half>(a, s);
        }
        err = cudaGetLastError();
    }
    if (current >= 0 && current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
