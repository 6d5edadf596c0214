// Hopper (sm_90a) primitives of the D = 64 attention kernels: mbarriers,
// TMA loads through 4-D tensor maps with the 128-byte swizzle, wgmma from
// shared-memory descriptors and from registers, and the exp2-domain softmax
// pieces on wgmma's accumulator layout. The element type T of q, k, v, P,
// out and a bias (__nv_bfloat16 or __half) is a template argument, resolved
// at compile time (Elem<T>): a wgmma issued under a run-time condition makes
// ptxas serialize every wgmma of the kernel (C7520). Shared by
//   flash_attention_sm90.cu  #1, #2, #4, #5 (the serving kernel)
//   flash_staged_sm90.cu     #11 (the sweep's two-pass schedule)
//   flash_xl_sm90.cu         #10 (the sweep's qp / pipelined schedules)
// The D = 32 window kernel (window_attention_sm90.cu) has its own 64-byte
// swizzle versions.
//
// Accumulator layout of an m64nN wgmma, per warp of the warpgroup (16 rows):
// this thread holds rows g and g + 8 (g = lane / 4, c = lane % 4) and, for
// each 8-column block i < N / 8, s[4i + e] at row g + 8 (e >> 1), column
// 8i + 2c + (e & 1): mma.sync's m16n8 C fragment repeated along N.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 64;              // head dim: one 128-byte swizzle row of a 16-bit type
constexpr float NEG_INF = -1e30f;  // the JAX package's masking constant
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// A warp's arrival on an empty barrier (lane 0 arrives for the warp)
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
    if (lane == 0) mbar_arrive(bar);
}

// One 4-D box at coordinates (c0, c1, c2, c3), innermost first, into shared
// memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// issue or wait: the accumulators change asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int J>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// wgmma descriptor of a 128B-swizzled tile of 128-byte rows: start address
// >> 4, leading byte offset 1 (unused by the swizzled layouts at these
// widths), stride byte offset 1024 B >> 4 (from one 8-row group to the
// next), swizzle mode 1 (128B). Both the K-major Q and K tiles and the
// MN-major V tile have this layout; a k step moves the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define ACC8(i) \
    "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// The wgmma instructions at the element type TY ("bf16" or "f16"): f32
// accumulators, both operand types TY.
#define WGMMA_QK_N128(TY)                                                                              \
    asm volatile(                                                                                      \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                   \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                                   \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "             \
        "%64, %65, p, 1, 1, 0, 0;\n}\n"                                                                \
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)                 \
        : "l"(desc_a), "l"(desc_b), "r"(accumulate))
#define WGMMA_QK_N64(TY)                                                                               \
    asm volatile(                                                                                      \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                   \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                                    \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "             \
        "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                                \
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)                                                         \
        : "l"(desc_a), "l"(desc_b), "r"(accumulate))
#define WGMMA_QK_N32(TY)                                                                               \
    asm volatile(                                                                                      \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                   \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                                    \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "                      \
        "%16, %17, p, 1, 1, 0, 0;\n}\n"                                                                \
        : ACC8(0), ACC8(8)                                                                             \
        : "l"(desc_a), "l"(desc_b), "r"(accumulate))
#define WGMMA_PV_N64(TY)                                                                               \
    asm volatile(                                                                                      \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                   \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                                    \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "             \
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                  \
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d (64 rows x 128 keys, f32) = or += A (64 x 16 of D) B^T (128 keys x 16 of D), both K-major in shared memory
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    if constexpr (std::is_same<T, __half>::value) WGMMA_QK_N128("f16"); else WGMMA_QK_N128("bf16");
}

// The same over 64 keys: d (64 rows x 64 keys, f32)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    if constexpr (std::is_same<T, __half>::value) WGMMA_QK_N64("f16"); else WGMMA_QK_N64("bf16");
}

// The same over 32 keys: d (64 rows x 32 keys, f32)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_qk(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    if constexpr (std::is_same<T, __half>::value) WGMMA_QK_N32("f16"); else WGMMA_QK_N32("bf16");
}

// d (64 rows x 64, f32) += A (64 x 16 keys, T registers) B (16 keys x 64, MN-major in shared memory)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    if constexpr (std::is_same<T, __half>::value) WGMMA_PV_N64("f16"); else WGMMA_PV_N64("bf16");
}

#undef WGMMA_QK_N128
#undef WGMMA_QK_N64
#undef WGMMA_QK_N32
#undef WGMMA_PV_N64
#undef ACC8

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// What differs between the element types: the tensor maps' data type, two
// f32 values rounded into one 32-bit register (P's A fragment, out), and
// the two f32 values of a register of two elements (a bias pair read by
// ldmatrix). bf16 is the top half of an f32, so its unpack is a shift; f16
// needs a conversion (cvt.f32.f16).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
    static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
    static __device__ __forceinline__ float lo(uint32_t x) { return __uint_as_float(x << 16); }
    static __device__ __forceinline__ float hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }
};

template <>
struct Elem<__half> {
    static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        __half2 v = __floats2half2_rn(lo, hi);  // cvt.rn.f16x2.f32; .x (lo) in the low half
        return *reinterpret_cast<uint32_t*>(&v);
    }
    static __device__ __forceinline__ float lo(uint32_t x) { return __half2float(__ushort_as_half(static_cast<unsigned short>(x))); }
    static __device__ __forceinline__ float hi(uint32_t x) { return __half2float(__ushort_as_half(static_cast<unsigned short>(x >> 16))); }
};

// S = Q K^T over D = 64: four k steps of 16 (32 bytes along the swizzled
// rows); the key tile's width is the accumulator's (64 floats: 128 keys,
// 32: 64 keys, 16: 32 keys)
template <typename T, int NS>
__device__ __forceinline__ void issue_qk(float (&s)[NS], uint64_t dq, const T* k_tile) {
    const uint64_t dk = sw128_desc(k_tile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_qk<T>(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// O += P V over 16 J keys: J k steps of 16 keys (16 rows of 128 B = 2048 B)
template <typename T, int J>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[J][4], const T* v_tile) {
    const uint64_t dv = sw128_desc(v_tile);
#pragma unroll
    for (int j = 0; j < J; ++j) wgmma_pv<T>(o, p[j], dv + j * (16 * 128 >> 4));
}

// This thread holds rows g and g + 8 of its warp's 16 in an S tile:
// s[4i + e] is row g + 8 (e >> 1), key kbase + 8i + 2c + (e & 1).
__device__ __forceinline__ bool key_masked(int kbase, int i, int e, int c, int n) { return kbase + 8 * i + 2 * c + (e & 1) >= n; }

// The raw row max of s (of -s for a negative scale), keys at or past N left out.
template <bool MASK, bool NEG, int NS>
__device__ __forceinline__ void row_max(const float (&s)[NS], float (&mx)[2], int kbase, int n, int c) {
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x = NEG ? -s[4 * i + e] : s[4 * i + e];
            mx[e >> 1] = fmaxf(mx[e >> 1], MASK && key_masked(kbase, i, e, c, n) ? -INFINITY : x);
        }
    }
}

// P in T: the S fragments of keys 16j..16j+15 are the A fragment of PV k step j
template <typename T = __nv_bfloat16, int J>
__device__ __forceinline__ void pack_p(uint32_t (&p)[J][4], const float (&s)[8 * J]) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[j][i] = Elem<T>::pack(s[8 * j + 2 * i], s[8 * j + 2 * i + 1]);
    }
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// A 4-D tensor map of 16-bit elements of `type`, 128B swizzle, zeros past
// the edges. `stride` holds the byte strides of dims 1-3; a dim of size 1
// is never stepped over, so it gets a packed stride whatever the caller's
// (TMA takes non-zero multiples of 16 B).
CUresult encode4(EncodeTiled fn, CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4], cuuint64_t (&stride)[3],
                 const cuuint32_t (&box)[4], CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
    for (int i = 0; i < 3; ++i)
        if (dims[i + 1] == 1) stride[i] = i == 0 ? dims[0] * 2 : stride[i - 1] * dims[i];
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return fn(map, type, 4, const_cast<void*>(ptr), dims, stride, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The (D, H, N, B) tensor map of q, k or v: `st` holds the element strides (batch, row, head).
CUresult encode_qkv(EncodeTiled fn, CUtensorMap* map, const void* ptr, const long long* st, int batch, int n, int heads,
                    cuuint32_t box_rows, CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
    const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(batch)};
    cuuint64_t stride[3] = {static_cast<cuuint64_t>(st[2]) * 2, static_cast<cuuint64_t>(st[1]) * 2,
                            static_cast<cuuint64_t>(st[0]) * 2};
    return encode4(fn, map, ptr, dims, stride, {D, 1, box_rows, 1}, type);
}

}  // namespace
