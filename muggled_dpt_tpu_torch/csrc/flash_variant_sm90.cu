// TPU kernel #12 for Hopper (sm_90a), bfloat16: tools/attn_variants.py:
// flash_variant (:137) -> _onepass_kernel (:77) and _innerloop_kernel (:110),
// attention on pre-scaled (BH, N, D) q, k and v, D = 64, on #1's Hopper
// pipeline (flash_attention_sm90.cu; the pieces shared with #10 and #11 in
// flash_variants_sm90.cuh). The C entry mdpt_flash_variant
// (flash_variant.cu) sends every bfloat16 launch here; float32 runs fv_f32
// (flash_variants.cuh).
//
// The (BH, N, D) tensors arrive as (B = BH, N, H = 1, D) and are read
// through #1's 4-D tensor maps: K and V rows at or past N arrive as zeros.
// Per row, over the keys j < K_end (the `keys` the wrapper passes), with
// s = q . k scaled by scale_log2 (the exp2 domain):
//   MODE MASK (mask_exp, mask_exp2): #1's online softmax, keys at or past
//       K_end = N masked by index (left out of the max, p = 0);
//       scale_log2 = log2(e) for mask_exp (the natural exp of the pre-scaled
//       logit as exp2 of the scaled one: only the rounding differs) and 1
//       for mask_exp2;
//   MODE PADFIX (padfix, chunk=c): keys in [N, K_end) are TMA's zero rows,
//       logit 0, as the JAX wrapper's zero padding makes them: they count in
//       the row max and in l; keys at or past K_end are masked by index (the
//       chunk cut K_end = (N_pad // c) c can end inside a key tile). At the
//       end l -= max(0, K_end - N) 2^-m. The JAX chunk loop takes each
//       chunk's pads off its own partial sum at that chunk's running max;
//       rescaled through the online softmax to the final max those are this
//       one correction (m is the running max and l corr carries it), so the
//       kernel needs no chunk boundaries and only the rounding differs. The
//       pad keys stay in the max and in l on purpose: with every real logit
//       far below 0 the pads win the max and the correction cancels the row
//       sum, the JAX kernels' failure, kept;
//   ablations, l = 1, over the same keys and pads as padfix:
//     NOSM p = s; EXPONLY p = exp2(s) (inf past logit 128, as the plain
//     version); MAXONLY p = s - m with the final row max m over the K_end
//     keys, pads included: a first pass streams K alone for it (pairs of
//     QK^T tiles, nothing in flight across the loop, as #11's pass 1 with
//     one panel; the max of s * scale, so a scale of either sign).
// p is rounded to bf16 before PV; out = acc / max(l, 1e-30) rounded to bf16;
// q rows past N are computed on zeros and never written.
//
// Design: one producer warpgroup (setmaxnreg.dec 24) whose thread 0 issues
// TMA: the Q tile once, then K and V tiles of 128 keys into two 2-stage
// rings (MAXONLY: pass 1's K tiles first, through the same ring); QP
// consumer warpgroups of 64 q rows, S = Q K^T and O += P V on wgmma, tile
// t's QK^T and tile t-1's PV issued together and tile t's weights computed
// under PV_{t-1} (#1's order). The mode and the height (QP) are template
// parameters, chosen on the host: no wgmma sits under a run-time
// condition, no instantiation has a short tail, and no wgmma wait retires a
// group issued before a loop's back edge (ptxas C7520, C7511, C7514).
// The height: HEIGHT = 3 consumer warpgroups (192 q rows, 512 threads, 1
// CTA per SM) was the fastest of 64, 128 and 192 rows at both the JAX
// tool's (16, 1297, 64) and the 1904x1904 ladder slab's (16, 18497, 64) on
// an H100 (PERF.md; tools/shootout_head_variants.py builds the others).
// Bound on an H100: 4 BH N K_end D tensor-core operations (6.89 GFLOP,
// 0.0070 ms at (16, 1297, 64)) and one exp2 per (q, k) pair.

#include "flash_variants_sm90.cuh"

namespace {

// The kernel's modes (the C entry maps flash_variants.cuh's Mode onto them)
enum FvMode { FV_MASK = 0, FV_PADFIX = 1, FV_NOSM = 2, FV_EXPONLY = 3, FV_MAXONLY = 4 };

constexpr int BKV = 128;  // keys per K / V tile
constexpr int STAGES = 2;
constexpr int HEIGHT = 3;  // consumer warpgroups of 64 q rows per CTA

template <int QP>
struct FvShape {
    static constexpr int THREADS = 128 * (1 + QP);
    static constexpr int BQ = 64 * QP;
    static constexpr int CTAS_PER_SM = QP == 1 ? 2 : 1;
    static constexpr int LAUNCH_REGS = 65536 / (THREADS * CTAS_PER_SM) / 8 * 8;
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int CONSUMER_REGS = (LAUNCH_REGS * THREADS - 128 * PRODUCER_REGS) / (128 * QP) / 8 * 8;
    static constexpr int CTA_REGS = 128 * (PRODUCER_REGS + QP * CONSUMER_REGS);
    using Smem = VSmem<BQ, BKV, STAGES, STAGES>;
    static constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // slack to align the base
};

struct FvParams {
    VParams v;  // out, its strides, N (q rows and real keys), scale_log2
    int kend;   // keys taken: those at or past it are masked by index
};

// Pass 1 of MAXONLY: the row max of s * scale_log2 of one S tile, keys at or past kend left out (MASK).
template <bool MASK>
__device__ __forceinline__ void scaled_max(const float (&s)[64], float (&mx)[2], float scale_log2, int kbase, int kend, int c) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x = s[4 * i + e] * scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], MASK && key_masked(kbase, i, e, c, kend) ? -INFINITY : x);
        }
    }
}

// Pass 1, key tiles t and t+1: both QK^T issued together, tile t's max
// taken while tile t+1's is in flight; nothing in flight across the loop.
template <bool MASK, class Smem>
__device__ __forceinline__ void max_pair(Smem& sm, float (&sa)[64], float (&sb)[64], float (&mx)[2], uint64_t dq, int t,
                                         float scale_log2, int kend, int lane, int c) {
    const int sta = stage_of<STAGES>(t), stb = stage_of<STAGES>(t + 1);
    mbar_wait(&sm.full_k[sta], parity_of<STAGES>(t));
    mbar_wait(&sm.full_k[stb], parity_of<STAGES>(t + 1));
    fence_regs(sa);
    fence_regs(sb);
    wgmma_fence();
    issue_qk(sa, dq, sm.k[sta]);
    wgmma_commit();
    issue_qk(sb, dq, sm.k[stb]);
    wgmma_commit();
    wgmma_wait<1>();  // QK^T_t
    fence_regs(sa);
    release(&sm.empty_k[sta], lane);
    scaled_max<MASK>(sa, mx, scale_log2, t * BKV, kend, c);
    wgmma_wait<0>();  // QK^T_{t+1}
    fence_regs(sb);
    release(&sm.empty_k[stb], lane);
    scaled_max<MASK>(sb, mx, scale_log2, (t + 1) * BKV, kend, c);
}

// Pass 1 over every key tile, two at a time (an odd count's extra tile is
// the last one loaded again, every key masked); only the last pair masks.
// Returns the row max of the scaled logits, quad-uniform, in m.
template <class Smem>
__device__ __forceinline__ void max_pass(Smem& sm, float (&m)[2], uint64_t dq, int tiles, float scale_log2, int kend, int lane,
                                         int c) {
    float sa[64], sb[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sa[i] = sb[i] = 0.f;  // overwritten by the first k step; keeps the operand defined
    float mx[2] = {-INFINITY, -INFINITY};
    int t = 0;
    for (; t + 2 < tiles; t += 2) max_pair<false>(sm, sa, sb, mx, dq, t, scale_log2, kend, lane, c);
    max_pair<true>(sm, sa, sb, mx, dq, t, scale_log2, kend, lane, c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        m[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
}

// A mode without a softmax: p of one S tile in place, 0 for keys at or past kend (MASK).
template <int MODE, bool MASK>
__device__ __forceinline__ void plain_tile(float (&s)[64], const float (&m)[2], float scale_log2, int kbase, int kend, int c) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float p;
            if constexpr (MODE == FV_NOSM) {
                p = s[4 * i + e] * scale_log2;
            } else if constexpr (MODE == FV_EXPONLY) {
                p = ex2(s[4 * i + e] * scale_log2);
            } else {
                p = fmaf(s[4 * i + e], scale_log2, -m[e >> 1]);
            }
            s[4 * i + e] = MASK && key_masked(kbase, i, e, c, kend) ? 0.f : p;
        }
    }
}

// Tile weights in place: the online softmax (MASK, PADFIX: alpha for O), or the ablation's p.
template <int MODE>
__device__ __forceinline__ void weights(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                        int kbase, int kend, int c) {
    if constexpr (MODE == FV_MASK || MODE == FV_PADFIX) {
        softmax_tile(s, m, l, alpha, scale_log2, kbase, kend, c);
    } else if (kbase + BKV <= kend) {
        plain_tile<MODE, false>(s, m, scale_log2, kbase, kend, c);
    } else {
        plain_tile<MODE, true>(s, m, scale_log2, kbase, kend, c);
    }
}

// Consumer warpgroup `wg`: q rows q0 + 64 wg .. + 63 over the K_end keys.
// K ring slot of key tile t: k0 + t (MAXONLY's pass 1 takes slots 0 .. k0 - 1); V ring slot t.
template <int QP, int MODE>
__device__ __forceinline__ void fv_consume(typename FvShape<QP>::Smem& sm, const FvParams& a, int wg, int q0, int b, int h,
                                           int tiles) {
    constexpr bool SOFTMAX = MODE == FV_MASK || MODE == FV_PADFIX;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int kend = a.kend;
    const float sl2 = a.v.qk_scale_log2;
    const uint64_t dq = sw128_desc(sm.q + wg * 64 * D);

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(&sm.full_q, 0);
    int k0 = 0;
    if constexpr (MODE == FV_MAXONLY) {  // pass 1 first, before O takes its registers
        max_pass(sm, m, dq, tiles, sl2, kend, lane, c);
        k0 = tiles + (tiles & 1);
    }
    float o[32], alpha[2], s[64];
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    // key tile 0: S only
    mbar_wait(&sm.full_k[stage_of<STAGES>(k0)], parity_of<STAGES>(k0));
    wgmma_fence();
    issue_qk(s, dq, sm.k[stage_of<STAGES>(k0)]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(&sm.empty_k[stage_of<STAGES>(k0)], lane);
    weights<MODE>(s, m, l, alpha, sl2, 0, kend, c);
    pack_p(p, s);
    // key tile t: S_t and PV_{t-1} issued together, tile t's weights under PV_{t-1}
    for (int t = 1; t < tiles; ++t) {
        const int kst = stage_of<STAGES>(k0 + t), vst = stage_of<STAGES>(t - 1);
        mbar_wait(&sm.full_k[kst], parity_of<STAGES>(k0 + t));
        mbar_wait(&sm.full_v[vst], parity_of<STAGES>(t - 1));
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_qk(s, dq, sm.k[kst]);
        wgmma_commit();
        issue_pv(o, p, sm.v[vst]);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        release(&sm.empty_k[kst], lane);
        weights<MODE>(s, m, l, alpha, sl2, t * BKV, kend, c);
        wgmma_wait<0>();
        fence_regs(o);
        release(&sm.empty_v[vst], lane);
        if constexpr (SOFTMAX) rescale(o, alpha);
        pack_p(p, s);
    }
    // the last PV
    const int vst = stage_of<STAGES>(tiles - 1);
    mbar_wait(&sm.full_v[vst], parity_of<STAGES>(tiles - 1));
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv(o, p, sm.v[vst]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (SOFTMAX) {  // out = acc / max(l, 1e-30), PADFIX's pads taken off l first
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            if constexpr (MODE == FV_PADFIX) {
                const int pads = kend - a.v.n;
                if (pads > 0) l[r] -= (float)pads * ex2(-m[r]);
            }
            const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                o[4 * i + 2 * r] /= lr;
                o[4 * i + 2 * r + 1] /= lr;
            }
        }
    }
    store_rows<false>(o, l, a.v, q0 + wg * 64 + warp * 16 + g, b, h, c);
}

template <int QP, int MODE>
__global__ void __launch_bounds__(FvShape<QP>::THREADS, FvShape<QP>::CTAS_PER_SM)
    fv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const FvParams a) {
    using Shape = FvShape<QP>;
    extern __shared__ uint8_t smem_raw[];
    auto& sm = aligned_smem<typename Shape::Smem>(smem_raw);
    const int b = blockIdx.x, q0 = blockIdx.y * Shape::BQ, h = blockIdx.z;  // batch fastest
    const int tiles = (a.kend + BKV - 1) / BKV;

    if (threadIdx.x == 0) init_barriers<STAGES, STAGES>(sm, 4 * QP);
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every TMA copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Shape::PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            mbar_expect_tx(&sm.full_q, Shape::BQ * D * 2);
            tma_load(sm.q, &tq, &sm.full_q, 0, h, q0, b);
            int k0 = 0;
            if constexpr (MODE == FV_MAXONLY) {  // pass 1: K only; an odd count's extra tile is the last one again
                k0 = tiles + (tiles & 1);
                for (int t = 0; t < k0; ++t) load_tile<BKV>(sm.k, sm.full_k, sm.empty_k, &tk, t, min(t, tiles - 1) * BKV, h, b);
            }
            for (int t = 0; t < tiles; ++t) {
                load_tile<BKV>(sm.k, sm.full_k, sm.empty_k, &tk, k0 + t, t * BKV, h, b);
                load_tile<BKV>(sm.v, sm.full_v, sm.empty_v, &tv, t, t * BKV, h, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Shape::CONSUMER_REGS) : "memory");
        fv_consume<QP, MODE>(sm, a, threadIdx.x / 128 - 1, q0, b, h, tiles);
    }
}

template <int QP, int MODE>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const FvParams& p, int batch,
                   int heads, cudaStream_t stream) {
    using Shape = FvShape<QP>;
    static std::atomic<unsigned long long> configured{0};
    const cudaError_t err = configure(fv_sm90<QP, MODE>, Shape::THREADS, Shape::CTA_REGS, Shape::SMEM_BYTES, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid(batch, (p.v.n + Shape::BQ - 1) / Shape::BQ, heads);
    fv_sm90<QP, MODE><<<grid, Shape::THREADS, Shape::SMEM_BYTES, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

template <int QP>
cudaError_t launch_height(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                          const long long* v_st, const FvParams& p, int batch, int heads, int mode, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    const cudaError_t err =
        encode_operands(tq, tk, tv, q, q_st, k, k_st, v, v_st, batch, p.v.n, heads, FvShape<QP>::BQ, BKV);
    if (err != cudaSuccess) return err;
    switch (mode) {
        case FV_MASK: return launch<QP, FV_MASK>(tq, tk, tv, p, batch, heads, stream);
        case FV_PADFIX: return launch<QP, FV_PADFIX>(tq, tk, tv, p, batch, heads, stream);
        case FV_NOSM: return launch<QP, FV_NOSM>(tq, tk, tv, p, batch, heads, stream);
        case FV_EXPONLY: return launch<QP, FV_EXPONLY>(tq, tk, tv, p, batch, heads, stream);
        case FV_MAXONLY: return launch<QP, FV_MAXONLY>(tq, tk, tv, p, batch, heads, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <int QP>
int info_of(int mode, int* out) {
    using Shape = FvShape<QP>;
    int err;
    switch (mode) {
        case FV_MASK: err = resources(fv_sm90<QP, FV_MASK>, Shape::SMEM_BYTES, out); break;
        case FV_PADFIX: err = resources(fv_sm90<QP, FV_PADFIX>, Shape::SMEM_BYTES, out); break;
        case FV_NOSM: err = resources(fv_sm90<QP, FV_NOSM>, Shape::SMEM_BYTES, out); break;
        case FV_EXPONLY: err = resources(fv_sm90<QP, FV_EXPONLY>, Shape::SMEM_BYTES, out); break;
        case FV_MAXONLY: err = resources(fv_sm90<QP, FV_MAXONLY>, Shape::SMEM_BYTES, out); break;
        default: return (int)cudaErrorInvalidValue;
    }
    out[5] = BKV;
    out[6] = Shape::CONSUMER_REGS;
    return err;
}

}  // namespace

// Launch #12 on the current device. Pointers and (batch, row, head) element
// strides of q, k, v and out, as flash_variant.cu's VArgs carries them; the
// caller has checked that tensor maps can read them (16-byte aligned bases
// and strides). kend: the keys taken; mode: an FvMode; qk_scale_log2: the
// logit's scale into the exp2 domain. Returns the error of a tensor-map
// encode (a CUresult, whose codes agree with cudaError_t's for invalid
// values) or of the launch.
cudaError_t flash_variant_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                               const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads, int kend,
                               int mode, float qk_scale_log2, cudaStream_t stream) {
    if (kend < 1) return cudaErrorInvalidValue;
    const FvParams p{{static_cast<__nv_bfloat16*>(o), o_st[0], o_st[1], o_st[2], n, 1, qk_scale_log2}, kend};
    return launch_height<HEIGHT>(q, q_st, k, k_st, v, v_st, p, batch, heads, mode, stream);
}

// An instantiation's resources, for a report (mode an FvMode): registers
// per thread at launch (before setmaxnreg), local memory (spill) bytes per
// thread, static and dynamic shared memory bytes, threads per block; then
// its key tile and the consumers' registers after setmaxnreg. Returns the
// cudaError_t.
extern "C" int mdpt_flash_variant_sm90_info(int mode, int* out) { return info_of<HEIGHT>(mode, out); }
