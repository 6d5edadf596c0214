// Bilinear upsample with align_corners=True for Hopper (sm_90a), float32,
// bfloat16 and float16: the DPT neck's resize (models/dpt_neck.py: each
// FusionBlock's 2x upsample and the Head's upsample by P/8 or 2). Per output
// pixel (oy, ox) of a (B, C, HO, WO) map from a (B, C, H, W) one:
//   src = scale * dst,  scale = (in - 1) / (out - 1) in float32 (0 when out is 1)
//   i0 = (int)src,  i1 = i0 + (i0 < in - 1),  l1 = src - i0,  l0 = 1 - l1
//   out = l0h * (l0w * x[y0][x0] + l1w * x[y0][x1]) + l1h * (l0w * x[y1][x0] + l1w * x[y1][x1])
// in float32, rounded once to the output's type: PyTorch's upsample_bilinear2d
// (area_pixel_compute_scale / _source_index) term for term, with the FMAs its
// CUDA kernels compile to written out, so the result is F.interpolate(x, size,
// mode="bilinear", align_corners=True) bit for bit in every dtype. Which FMAs
// those are was measured on an H100 against all 27 contractions of the three
// sums: one order everywhere but in its float32 channels-last kernel, which
// has another (lerp_nhwc). An output of the input's size is a copy, as there.
//
// It replaces no Pallas kernel: the JAX package resizes with separable banded
// matrix products on the MXU (muggled_dpt_tpu/ops/resize.py:_apply_linear_bf16),
// a TPU tactic. On the H100 the operation is four taps and six multiply-adds an
// element, far below the ridge: its bound is bytes, each input read once and
// each output written once. At 504 x 504, B = 8, the neck's five upsamples
// move 1.25 GB of bf16 (0.37 ms at 3.35 TB/s); PyTorch's channels-last kernel
// took 4.4 ms for them, with one thread per element doing four integer
// divisions and 2-byte accesses.
//
// Design: a thread walks ROWS output rows down its output columns (V
// channels of one pixel, channels-last, or VW columns of one plane, NCHW) and
// keeps the two input rows' taps it read for one output row while the next
// output row reads them too: at an upsampling of 1.75-2x each input element
// is then loaded about once per output column, not twice, and the taps and
// the bookkeeping are paid once per row for all of the thread's outputs.
// Neighbouring threads own neighbouring columns, so each warp's loads and
// stores fall on neighbouring sectors (plain stores: streaming ones, tried,
// were slower). The input is read in place in either memory format, through
// its strides:
// * channels-last (upsample_ac_cl): a thread owns one output pixel x V
//   channels per row, channel chunks fastest, then columns (grid x), row
//   groups (y) and images (z); its taps are 16-byte loads and its store one
//   16-byte store. V is 16 / sizeof(T) when the channels are a multiple of it
//   and the addresses 16-byte aligned; otherwise V = 1, one element a thread.
// * NCHW (upsample_ac_nchw): a thread owns VW consecutive output columns of
//   one plane's row group, column chunks fastest; its taps are scalar loads
//   (L1 serves the overlap between neighbouring threads) and its store one
//   VW-element store. VW is the most of 8, 4, 2, 1 that divides the output's
//   width (and its address), so rows of any width keep their stores aligned.
// Its times on an H100 against the byte floor are in PERF.md's kernel table.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int ROWS = 16;  // output rows a thread walks down its column
constexpr long long MAX_GRID_YZ = 65535;

struct UpsampleArgs {
    const void* x;
    void* out;
    long long sb, sc, sh, sw;  // the input's element strides
    int c, h, w, ho, wo;
    float scale_h, scale_w;
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

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
    T v[V];
};

struct Tap {
    int i0, i1;
    float l0, l1;
};

// PyTorch's source index with align_corners=True, and its two weights, each
// product and difference rounded (no FMA may fuse them, as none does there).
__device__ __forceinline__ Tap tap(float scale, int dst, int in) {
    const float src = __fmul_rn(scale, (float)dst);
    const int i0 = (int)src;
    const int i1 = i0 + (i0 < in - 1 ? 1 : 0);
    const float l1 = __fsub_rn(src, (float)i0);
    return {i0, i1, __fsub_rn(1.f, l1), l1};
}

// The two orders PyTorch's kernels compile the sum to, as explicit FMAs: its
// channels-last kernel (upsample_bilinear2d_nhwc_out_frame, which it takes at
// 4 channels or more) in float32, and every other (its generic kernel
// upsample_bilinear2d_out_frame, and the channels-last one in 16 bits).
__device__ __forceinline__ float lerp_nhwc(const Tap& ty, const Tap& tx, float x00, float x01, float x10, float x11) {
    const float top = __fmaf_rn(tx.l1, x01, __fmul_rn(tx.l0, x00));
    const float bottom = __fmaf_rn(tx.l0, x10, __fmul_rn(tx.l1, x11));
    return __fmaf_rn(ty.l0, top, __fmul_rn(ty.l1, bottom));
}

__device__ __forceinline__ float lerp_nchw(const Tap& ty, const Tap& tx, float x00, float x01, float x10, float x11) {
    const float top = __fmaf_rn(tx.l0, x00, __fmul_rn(tx.l1, x01));
    const float bottom = __fmaf_rn(tx.l0, x10, __fmul_rn(tx.l1, x11));
    return __fmaf_rn(ty.l0, top, __fmul_rn(ty.l1, bottom));
}

// The two input rows an output row reads, kept from the previous output row
// where it read them too: a thread walks ROWS output rows down its columns,
// so each input row is loaded once per column, not once per output row.
// v0[k] and v1[k] hold rows r0 and r1 at column k's two taps.
template <typename P, int K>
struct RowPair {
    int r0 = -1, r1 = -1;
    P v0[K][2], v1[K][2];

    template <typename Load>
    __device__ __forceinline__ void fetch(const Tap& ty, Load load) {
        if (ty.i0 != r0) {
            if (ty.i0 == r1) {
#pragma unroll
                for (int k = 0; k < K; ++k) v0[k][0] = v1[k][0], v0[k][1] = v1[k][1];
            } else {
                load(ty.i0, v0);
            }
            r0 = ty.i0;
        }
        if (ty.i1 != r1) {
            if (ty.i1 == r0) {
#pragma unroll
                for (int k = 0; k < K; ++k) v1[k][0] = v0[k][0], v1[k][1] = v0[k][1];
            } else {
                load(ty.i1, v1);
            }
            r1 = ty.i1;
        }
    }
};

template <typename T, int V, bool NHWC_ORDER>
__global__ void __launch_bounds__(THREADS) upsample_ac_cl(const UpsampleArgs a) {
    const int chunks = a.c / V;
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= a.wo * chunks) return;
    const int ox = j / chunks, c = (j - ox * chunks) * V;
    const int b = blockIdx.z, oy0 = blockIdx.y * ROWS, oy1 = min(oy0 + ROWS, a.ho);
    const Tap tx = tap(a.scale_w, ox, a.w);
    const T* x = static_cast<const T*>(a.x) + b * a.sb + c;
    typedef Pack<T, V> P;
    RowPair<P, 1> rows;
    const auto load = [&](int y, P (&at)[1][2]) {
        at[0][0] = *reinterpret_cast<const P*>(x + y * a.sh + tx.i0 * a.sw);
        at[0][1] = *reinterpret_cast<const P*>(x + y * a.sh + tx.i1 * a.sw);
    };
    T* out = static_cast<T*>(a.out) + (((long long)b * a.ho + oy0) * a.wo + ox) * a.c + c;
    for (int oy = oy0; oy < oy1; ++oy, out += (long long)a.wo * a.c) {
        const Tap ty = tap(a.scale_h, oy, a.h);
        rows.fetch(ty, load);
        P o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const float v00 = to_f(rows.v0[0][0].v[k]), v01 = to_f(rows.v0[0][1].v[k]);
            const float v10 = to_f(rows.v1[0][0].v[k]), v11 = to_f(rows.v1[0][1].v[k]);
            o.v[k] = from_f<T>(NHWC_ORDER ? lerp_nhwc(ty, tx, v00, v01, v10, v11) : lerp_nchw(ty, tx, v00, v01, v10, v11));
        }
        *reinterpret_cast<P*>(out) = o;
    }
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS) upsample_ac_nchw(const UpsampleArgs a, long long threads) {
    const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;  // ((plane, row group), column chunk)
    if (j >= threads) return;
    const int chunks = a.wo / VW, groups = (a.ho + ROWS - 1) / ROWS;
    const long long pg = j / chunks;
    const int ox = (int)(j - pg * chunks) * VW, p = (int)(pg / groups), oy0 = (int)(pg - (long long)p * groups) * ROWS;
    const int oy1 = min(oy0 + ROWS, a.ho);
    Tap tx[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) tx[k] = tap(a.scale_w, ox + k, a.w);
    const T* x = static_cast<const T*>(a.x) + (long long)(p / a.c) * a.sb + (long long)(p % a.c) * a.sc;
    RowPair<float, VW> rows;
    const auto load = [&](int y, float (&at)[VW][2]) {
        const T* row = x + y * a.sh;
#pragma unroll
        for (int k = 0; k < VW; ++k) at[k][0] = to_f(__ldg(row + tx[k].i0)), at[k][1] = to_f(__ldg(row + tx[k].i1));
    };
    T* out = static_cast<T*>(a.out) + ((long long)p * a.ho + oy0) * a.wo + ox;
    for (int oy = oy0; oy < oy1; ++oy, out += a.wo) {
        const Tap ty = tap(a.scale_h, oy, a.h);
        rows.fetch(ty, load);
        Pack<T, VW> o;
#pragma unroll
        for (int k = 0; k < VW; ++k)
            o.v[k] = from_f<T>(lerp_nchw(ty, tx[k], rows.v0[k][0], rows.v0[k][1], rows.v1[k][0], rows.v1[k][1]));
        *reinterpret_cast<Pack<T, VW>*>(out) = o;
    }
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_X = 0,      // (B, C, H, W) input
    SLOT_STRIDE_B,   // its element strides: the channel stride is 1 (channels-last) or the width stride is (NCHW)
    SLOT_STRIDE_C,
    SLOT_STRIDE_H,
    SLOT_STRIDE_W,
    SLOT_OUT,        // (B, C, HO, WO), dense in the memory format SLOT_LAYOUT names
    SLOT_BATCH,
    SLOT_CHANNELS,
    SLOT_IN_H,
    SLOT_IN_W,
    SLOT_OUT_H,
    SLOT_OUT_W,
    SLOT_LAYOUT,     // 0 = NCHW, 1 = channels-last
    SLOT_DTYPE,      // 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_DEVICE,     // the CUDA device of both tensors
    NUM_SLOTS,
};

constexpr long long LAYOUT_NCHW = 0, LAYOUT_CL = 1;

// PyTorch's area_pixel_compute_scale with align_corners=True, in float32.
float scale_of(long long in, long long out) { return out > 1 ? (float)(in - 1) / (float)(out - 1) : 0.f; }

template <typename T, int V>
void launch_cl(const dim3& grid, bool nhwc_order, const UpsampleArgs& a, cudaStream_t s) {
    if (nhwc_order) {
        upsample_ac_cl<T, V, true><<<grid, THREADS, 0, s>>>(a);
    } else {
        upsample_ac_cl<T, V, false><<<grid, THREADS, 0, s>>>(a);
    }
}

template <typename T>
cudaError_t launch(const long long* args, const UpsampleArgs& a, long long batch, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    if (args[SLOT_LAYOUT] == LAYOUT_CL) {
        const bool wide = args[SLOT_X] % 16 == 0 && args[SLOT_OUT] % 16 == 0 && a.c % V == 0 && a.sw % V == 0 &&
                          a.sh % V == 0 && a.sb % V == 0;
        const bool nhwc = sizeof(T) == 4 && a.c >= 4;  // where PyTorch's kernel has the other FMA order
        const long long lanes = (long long)a.wo * (wide ? a.c / V : a.c);
        const dim3 grid((unsigned)((lanes + THREADS - 1) / THREADS), (unsigned)((a.ho + ROWS - 1) / ROWS), (unsigned)batch);
        if (wide) {
            launch_cl<T, V>(grid, nhwc, a, s);
        } else {
            launch_cl<T, 1>(grid, nhwc, a, s);
        }
    } else {
        // columns per thread: the most of 8, 4, 2 and 1 that divides the rows and aligns the output for its stores
        int vw = 8;
        while (vw > 1 && (a.wo % vw != 0 || args[SLOT_OUT] % (vw * (long long)sizeof(T)) != 0)) vw /= 2;
        const long long threads = batch * a.c * ((a.ho + ROWS - 1) / ROWS) * (a.wo / vw);
        const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
        if (vw == 8) {
            upsample_ac_nchw<T, 8><<<blocks, THREADS, 0, s>>>(a, threads);
        } else if (vw == 4) {
            upsample_ac_nchw<T, 4><<<blocks, THREADS, 0, s>>>(a, threads);
        } else if (vw == 2) {
            upsample_ac_nchw<T, 2><<<blocks, THREADS, 0, s>>>(a, threads);
        } else {
            upsample_ac_nchw<T, 1><<<blocks, THREADS, 0, s>>>(a, threads);
        }
    }
    return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid out
// as in `Slot`. The launch goes to args[SLOT_DEVICE]; the calling thread's
// current device is the same after the call as before. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int mdpt_upsample_bilinear_ac(const long long* args, void* stream) {
    const long long batch = args[SLOT_BATCH], c = args[SLOT_CHANNELS], h = args[SLOT_IN_H], w = args[SLOT_IN_W];
    const long long ho = args[SLOT_OUT_H], wo = args[SLOT_OUT_W], layout = args[SLOT_LAYOUT];
    const int dtype = (int)args[SLOT_DTYPE], device = (int)args[SLOT_DEVICE];
    const long long sb = args[SLOT_STRIDE_B], sc = args[SLOT_STRIDE_C], sh = args[SLOT_STRIDE_H], sw = args[SLOT_STRIDE_W];
    if (args[SLOT_X] == 0 || args[SLOT_OUT] == 0 || batch < 1 || c < 1 || h < 1 || w < 1 || ho < 1 || wo < 1)
        return (int)cudaErrorInvalidValue;
    if (batch > MAX_GRID_YZ || ho > MAX_GRID_YZ || c * ho * wo > (1LL << 31) || c * h * w > (1LL << 31) ||
        batch * c * ((ho + ROWS - 1) / ROWS) * wo / THREADS >= (1LL << 31) || dtype < 0 || dtype > 2)
        return (int)cudaErrorInvalidValue;
    if (!(layout == LAYOUT_CL && sc == 1) && !(layout == LAYOUT_NCHW && sw == 1)) return (int)cudaErrorInvalidValue;
    const UpsampleArgs a{reinterpret_cast<const void*>(args[SLOT_X]), reinterpret_cast<void*>(args[SLOT_OUT]),
                         sb, sc, sh, sw, (int)c, (int)h, (int)w, (int)ho, (int)wo,
                         scale_of(h, ho), scale_of(w, wo)};
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (h == ho && w == wo && (layout == LAYOUT_CL ? sw == c && sh == w * c : sh == w && sc == h * w) && sb == c * h * w) {
        const size_t bytes = (size_t)(batch * c * h * w) * (dtype == 0 ? 4 : 2);  // a dense input: one copy
        err = cudaMemcpyAsync(a.out, a.x, bytes, cudaMemcpyDeviceToDevice, s);
    } else if (dtype == 0) {
        err = launch<float>(args, a, batch, s);
    } else if (dtype == 1) {
        err = launch<bf16>(args, a, batch, s);
    } else {
        err = launch<__half>(args, a, batch, s);
    }
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
