// ViT-Giant's SwiGLU gate for Hopper (sm_90a), float32, bfloat16 and float16,
// in one pass. x12 is w12's contiguous (rows, 2H) output, its halves
// a = x12[:, :H] and b = x12[:, H:]; per element of the new contiguous
// (rows, H) output h:
//   s = a / (1 + exp(-a))   in float32, rounded to the dtype   (F.silu)
//   h = s * b               in float32, rounded to the dtype   (the product)
// The arithmetic is the composite's, ops/nn.py:mlp_swiglu's F.silu(a) * b on
// torch's CUDA kernels: silu from the converted a with expf and the IEEE
// division (this build has no fast-math), rounded to the dtype as F.silu
// returns it, then the product of the two converted values in float32,
// rounded once. So the pass is bit-equal to the composite, in each dtype.
//
// It replaces no Pallas kernel: the JAX package leaves the gate to XLA
// (muggled_dpt_tpu/ops/nn.py:79), which fuses it on the TPU. On the H100
// PyTorch ran it as two non-vectorized elementwise kernels over the strided
// halves, silu and then the product, which wrote and read silu(a) once more.
// The work is a few flops per byte: its bound is bytes, a and b read once and
// h written once, 6 bytes an element of h in bf16 (ViT-Giant at B=8, 504x504:
// (10376, 8192) -> (10376, 4096), 255 MB a launch, 0.0761 ms at 3.35 TB/s).
//
// Design: where a row of h is a whole number of 16-byte vectors and x12 is
// 16-byte aligned (every width of ViT-Giant, whole or split over ranks), a
// thread owns one 16-byte vector of h, so that each load and store of a warp
// covers 512 consecutive bytes of one row of a, b or h; the vector of h at
// index v lies in row v / (vectors a row), and its a and b at v * N + row * H
// and H further on (one division a vector, no index tensor); no shared
// memory. About 30 registers a thread keep 2048 threads an SM, each with its
// two loads in flight. Any other width (any H: the last dim is even) or
// alignment takes the general instance, one element a thread. Measured
// against two, four and eight vectors a thread (up to 77 registers, three
// blocks an SM: 84 to 61 % of the byte floor), 128 to 1024 threads a block
// (within 0.5 %), and evict-first or last-use loads (2 % slower alone), at
// the cell's shapes on an H100.
// Its times on an H100 against the byte floor are in PERF.md's kernel table.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

struct GateArgs {
    const void* x12;
    void* out;
    unsigned long long units;   // vectors of h (vector instance) or elements of h (general instance)
    unsigned long long hidden;  // H, the elements of a row of h
    unsigned row_vectors;       // 16-byte vectors of a row of h (vector instance)
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
__device__ __forceinline__ Vec<T> load(const T* p) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Vec<T>*>(&raw);
}

// silu(a) * b as the composite computes it: F.silu in float32 rounded to T,
// then the product in float32 rounded to T.
template <typename T>
__device__ __forceinline__ T gate(T a, T b) {
    const float x = to_f(a);
    const T s = from_f<T>(__fdiv_rn(x, __fadd_rn(1.0f, expf(-x))));
    return from_f<T>(__fmul_rn(to_f(s), to_f(b)));
}

// The vector instance: one 16-byte vector of h a thread.
template <typename T>
__global__ void __launch_bounds__(THREADS) swiglu_gate_sm90(const GateArgs g) {
    constexpr int N = Vec<T>::N;
    const unsigned v = blockIdx.x * THREADS + threadIdx.x;
    if (v >= g.units) return;
    const T* p = static_cast<const T*>(g.x12) + (size_t)v * N + (size_t)(v / g.row_vectors) * g.hidden;
    const Vec<T> a = load(p), b = load(p + g.hidden);
    Vec<T> h;
#pragma unroll
    for (int e = 0; e < N; ++e) h.v[e] = gate(a.v[e], b.v[e]);
    *reinterpret_cast<Vec<T>*>(static_cast<T*>(g.out) + (size_t)v * N) = h;
}

// The general instance: one element of h a thread.
template <typename T>
__global__ void __launch_bounds__(THREADS) swiglu_gate_any(const GateArgs g) {
    const unsigned long long i = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= g.units) return;
    const T* p = static_cast<const T*>(g.x12) + i + i / g.hidden * g.hidden;
    static_cast<T*>(g.out)[i] = gate(p[0], p[g.hidden]);
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_X12 = 0,  // (rows, 2H) contiguous: w12's output, [a | b] in each row
    SLOT_OUT,      // (rows, H) contiguous output
    SLOT_ROWS,
    SLOT_HIDDEN,   // H
    SLOT_VECTOR,   // 1: the vector instance (H * element size a multiple of 16, both pointers 16-byte aligned); 0: general
    SLOT_DTYPE,    // 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_DEVICE,   // the CUDA device of both tensors
    NUM_SLOTS,
};

template <typename T>
cudaError_t launch(const GateArgs& g, bool vector, cudaStream_t s) {
    const unsigned long long blocks = (g.units + THREADS - 1) / THREADS;
    if (vector) {
        swiglu_gate_sm90<T><<<(unsigned)blocks, THREADS, 0, s>>>(g);
    } else {
        swiglu_gate_any<T><<<(unsigned)blocks, THREADS, 0, s>>>(g);
    }
    return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid out
// as in `Slot`. The launch goes to args[SLOT_DEVICE]; the calling thread's
// current device is the same after the call as before. Returns the
// cudaError_t of the launch (0 on success, and for no rows, with no launch);
// the launch is asynchronous on `stream`.
extern "C" int mdpt_swiglu_gate(const long long* args, void* stream) {
    const long long x12 = args[SLOT_X12], out = args[SLOT_OUT], rows = args[SLOT_ROWS], hidden = args[SLOT_HIDDEN];
    const long long vector = args[SLOT_VECTOR], dtype = args[SLOT_DTYPE], device = args[SLOT_DEVICE];
    const long long elem = dtype == 0 ? 4 : 2;
    if (dtype < 0 || dtype > 2 || rows < 0 || hidden < 1 || hidden >= (1LL << 31) || rows >= (1LL << 31) ||
        (vector != 0 && vector != 1))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;  // nothing to launch (an empty tensor's address may be 0)
    if (x12 == 0 || out == 0) return (int)cudaErrorInvalidValue;
    const long long elements = rows * hidden;
    // the vector instance indexes vectors in 32 bits: below 2**31 of them (32 GB of h); the general one's grid
    // stays below 2**31 blocks
    if (elements >= (1LL << 39) ||
        (vector && (hidden * elem % 16 != 0 || x12 % 16 != 0 || out % 16 != 0 || elements * elem / 16 >= (1LL << 31))))
        return (int)cudaErrorInvalidValue;
    GateArgs g{reinterpret_cast<const void*>(x12), reinterpret_cast<void*>(out),
               (unsigned long long)(vector ? elements * elem / 16 : elements), (unsigned long long)hidden,
               (unsigned)(hidden * elem / 16)};
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice((int)device);
    if (err == cudaSuccess) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (dtype == 0) {
            err = launch<float>(g, vector, s);
        } else if (dtype == 1) {
            err = launch<bf16>(g, vector, s);
        } else {
            err = launch<__half>(g, vector, s);
        }
    }
    if (current >= 0 && current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
