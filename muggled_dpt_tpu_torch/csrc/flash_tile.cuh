// Tile code of the mma.sync flash attention kernel for Hopper (sm_90a),
// flash_attention.cu's fa_mma<T> (bf16 or f16 with a float32 bias); the
// measurement variants' float32 template (flash_variants.cuh) takes its
// constants.
//
// The kernel runs both attention products on the tensor cores with
// mma.sync m16n8k16 (bf16 or f16 in, f32 out): a warp owns 16 q rows, key
// tiles of 64 rows stream through shared memory by cp.async, rows padded to
// LDS elements so that fragment loads hit no bank conflicts. The element
// type T (__nv_bfloat16 or __half) is a template argument of the product
// and of the pack.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 64;              // head dim
constexpr float NEG_INF = -1e30f;  // the JAX package's masking constant
constexpr float LOG2E = 1.4426950408889634f;

constexpr int BK = 64;      // keys per tile
constexpr int LDS = D + 8;  // padded shared row (16-bit elements): conflict-free fragment loads

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

// Two f32 values rounded to T in one register, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    if constexpr (std::is_same<T, __half>::value) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    } else {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
}

#define MMA_16816(TY)                                                                                                   \
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "    \
                 "{%0,%1,%2,%3};\n"                                                                                     \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))

template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    if constexpr (std::is_same<T, __half>::value) MMA_16816("f16"); else MMA_16816("bf16");
}

#undef MMA_16816

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

}  // namespace
