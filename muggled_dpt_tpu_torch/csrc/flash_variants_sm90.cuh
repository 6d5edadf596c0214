// What the attention sweep's Hopper kernels share: #10 (flash_xl_sm90.cu)
// and #11 (flash_staged_sm90.cu) run on kernel #1's pipeline
// (flash_attention_sm90.cu): one producer warpgroup whose thread 0 issues
// TMA into mbarrier rings, consumer warpgroups of 64 q rows that run S = Q
// K^T by wgmma from shared-memory descriptors and O += P V by wgmma with P
// in registers, each kernel with its own schedule. The C entries
// (flash_attention_xl.cu, flash_attention_staged.cu) send them every
// bfloat16 launch; float32 stays on fv_f32 in flash_variants.cuh.
//
// Per batch b and head h, unbiased, D = 64, over the head-major qkv slab's
// q, k and v read in place through (batch, row, head) strides:
//   out[b, i, h, :] = sum_j softmax_j(q_i . k_j * scale) v_j,
// logits in the exp2 domain (s * scale * log2(e), the scale folded into one
// FFMA with the row max, taken on raw s, on -s for a negative scale); keys
// at or past N masked by index (TMA's zero rows would give logit 0, not
// -inf): left out of the max, p = 0, never a pad-count correction; l
// summed from the f32 p; p rounded to bf16 before PV; out = acc / max(l,
// 1e-30), rounded to bf16; q rows past N computed on zeros, never written.

#pragma once

#include <atomic>

#include "sm90_attention.cuh"

namespace {

struct VParams {
    __nv_bfloat16* o;
    long long sb, sn, sh;  // out's element strides: batch, row, head
    int n;
    int panel_tiles;  // #11: key tiles per panel of _panel_bounds
    float qk_scale_log2;
};

// One CTA's shared memory, at a 1024-byte aligned address (the 128B swizzle
// repeats every 8 rows): the Q tile, then rings of K and V tiles.
template <int BQ, int BKV, int KSTAGES, int VSTAGES>
struct VSmem {
    __nv_bfloat16 q[BQ * D];
    __nv_bfloat16 k[KSTAGES][BKV * D];
    __nv_bfloat16 v[VSTAGES][BKV * D];
    uint64_t full_q, full_k[KSTAGES], full_v[VSTAGES], empty_k[KSTAGES], empty_v[VSTAGES];
};

template <class Smem>
__device__ __forceinline__ Smem& aligned_smem(uint8_t* raw) {
    return *reinterpret_cast<Smem*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// Thread 0, before any other thread touches the barriers: a full barrier
// per stage takes the producer's one arrival (and the TMA bytes), an empty
// one an arrival from every consumer warp.
template <int KSTAGES, int VSTAGES, class Smem>
__device__ __forceinline__ void init_barriers(Smem& sm, int consumer_warps) {
    mbar_init(&sm.full_q, 1);
#pragma unroll
    for (int st = 0; st < KSTAGES; ++st) {
        mbar_init(&sm.full_k[st], 1);
        mbar_init(&sm.empty_k[st], consumer_warps);
    }
#pragma unroll
    for (int st = 0; st < VSTAGES; ++st) {
        mbar_init(&sm.full_v[st], 1);
        mbar_init(&sm.empty_v[st], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Ring slot `idx` (a running count of the tiles through the ring): its
// stage, and the parity of the phase that fills it.
template <int STAGES>
__device__ __forceinline__ int stage_of(int idx) { return idx % STAGES; }
template <int STAGES>
__device__ __forceinline__ uint32_t parity_of(int idx) { return (idx / STAGES) & 1; }

// The producer's thread 0: the tile of keys key0.. of k (or v) into ring
// slot idx, once the consumers have released the stage's previous tile
// (the first pass over the ring finds every stage free). A box past N
// arrives as zeros.
template <int BKV, int STAGES>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (&ring)[STAGES][BKV * D], uint64_t (&full)[STAGES],
                                          uint64_t (&empty)[STAGES], const CUtensorMap* map, int idx, int key0, int h,
                                          int b) {
    const int st = stage_of<STAGES>(idx);
    mbar_wait(&empty[st], parity_of<STAGES>(idx) ^ 1);
    mbar_expect_tx(&full[st], BKV * D * 2);
    tma_load(ring[st], map, &full[st], 0, h, key0, b);
}

// The online softmax of one S tile in place (#1's unbiased softmax over a
// tile of 2 NS keys): s becomes the f32 p, m the new row max of the logits
// (log2 units), alpha the factor for the old accumulator, l the rescaled
// partial row sum. MASK: keys at or past N count in neither.
template <bool MASK, int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               float scale_log2, int kbase, int n, int c) {
    float mx[2] = {-INFINITY, -INFINITY};
    if (scale_log2 >= 0.f) {
        row_max<MASK, false>(s, mx, kbase, n, c);
    } else {
        row_max<MASK, true>(s, mx, kbase, n, c);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * fabsf(scale_log2));
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[4 * i + e], scale_log2, -m[e >> 1]));
            s[4 * i + e] = MASK && key_masked(kbase, i, e, c, n) ? 0.f : p;
            l[e >> 1] += s[4 * i + e];
        }
    }
}

template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                             int kbase, int n, int c) {
    if (kbase + 2 * NS <= n) {
        online_softmax<false>(s, m, l, alpha, scale_log2, kbase, n, c);
    } else {
        online_softmax<true>(s, m, l, alpha, scale_log2, kbase, n, c);
    }
}

// The quad's (this row's four threads') sum and write-out of the 64 x 64 O
// tile: rows past N are not written; `normalize`: out = acc / max(l, 1e-30).
template <bool NORMALIZE>
__device__ __forceinline__ void store_rows(const float (&o)[32], float (&l)[2], const VParams& a, int row_g, int b, int h,
                                           int c) {
    __nv_bfloat16* ob = a.o + b * a.sb + h * a.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lr = 1.f;
        if constexpr (NORMALIZE) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            lr = fmaxf(l[r], 1e-30f);
        }
        const int row = row_g + 8 * r;
        if (row < a.n) {
            __nv_bfloat16* op = ob + row * a.sn;
#pragma unroll
            for (int i = 0; i < 8; ++i)
                *reinterpret_cast<uint32_t*>(op + 8 * i + 2 * c) = pack_bf16(o[4 * i + 2 * r] / lr, o[4 * i + 2 * r + 1] / lr);
        }
    }
}

// Once per device and kernel: a check that the registers granted at launch
// cover what setmaxnreg hands out (a short pool would leave the consumers
// waiting for registers forever), the dynamic shared memory limit and the
// largest shared-memory carveout (so that CTAs per SM fit).
template <class Kernel>
cudaError_t configure(Kernel* kernel, int threads, int cta_regs, int smem_bytes, std::atomic<unsigned long long>& configured) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (bit != 0 && (configured.load() & bit)) return cudaSuccess;
    cudaFuncAttributes at;
    err = cudaFuncGetAttributes(&at, kernel);
    if (err != cudaSuccess) return err;
    if (at.numRegs * threads < cta_regs) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
    return cudaSuccess;
}

// The (D, H, N, B) tensor maps of q, k and v: Q in boxes of `q_rows`, K and V in boxes of `kv_rows`.
inline cudaError_t encode_operands(CUtensorMap& tq, CUtensorMap& tk, CUtensorMap& tv, const void* q, const long long* q_st,
                                   const void* k, const long long* k_st, const void* v, const long long* v_st, int batch,
                                   int n, int heads, int q_rows, int kv_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    CUresult r = encode_qkv(fn, &tq, q, q_st, batch, n, heads, q_rows);
    if (r == CUDA_SUCCESS) r = encode_qkv(fn, &tk, k, k_st, batch, n, heads, kv_rows);
    if (r == CUDA_SUCCESS) r = encode_qkv(fn, &tv, v, v_st, batch, n, heads, kv_rows);
    return static_cast<cudaError_t>(r);
}

// An instantiation's resources, for a report: registers per thread at
// launch (before setmaxnreg), local memory (spill) bytes per thread, static
// and dynamic shared memory bytes, threads per block.
template <class Kernel>
int resources(Kernel* kernel, int smem_bytes, int* out) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)at.sharedSizeBytes;
    out[3] = smem_bytes;
    out[4] = at.maxThreadsPerBlock;
    return 0;
}

}  // namespace
