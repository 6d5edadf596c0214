// TPU kernel #10 for Hopper (sm_90a), bfloat16: experiments/flash_attention_xl.py:
// flash_attention_fused_qkv_xl (:140) -> _xl_qkv_kernel (:69), the XL-N
// schedules of #1 on the head-major (B, N, 3C) qkv slab, unbiased, D = 64,
// on #1's Hopper pipeline (flash_attention_sm90.cu; function and numerics
// in flash_variants_sm90.cuh). The C entry mdpt_flash_attention_xl
// (flash_attention_xl.cu) sends every bfloat16 launch here; float32 runs
// fv_f32 (flash_variants.cuh).
//
// The JAX kernel's knobs become instantiations (template QP, PIPELINED, MODE):
//   * qp: QP consumer warpgroups of 64 q rows per CTA share each K/V tile
//     of the TMA ring (the JAX "qp q sub-blocks per program sharing the
//     slab"; the consumers are the independent chains). One producer
//     warpgroup (setmaxnreg.dec to 24) whose thread 0 issues TMA: Q once,
//     then K and V tiles into two rings.
//   * pipelined = false: #1's order, S_t and PV_{t-1} issued together and
//     tile t's softmax under PV_{t-1} (the sweep's "qp=1 seq (anchor-equiv)").
//     pipelined = true: S double-buffered in registers; tile t+1's QK^T is
//     issued before tile t's softmax, PV_t after it, so the softmax runs
//     under the next tile's QK^T; PV_{t-1} is waited for before that QK^T
//     is issued (with both in flight under the softmax ptxas serialized
//     every wgmma, C7514). Its loop takes the tiles in pairs (a
//     register array cannot be chosen at run time, and a wgmma under a
//     runtime condition makes ptxas serialize every wgmma of the kernel,
//     C7520): an odd tile count gets one more key tile, the last one
//     loaded again and masked by index as keys past N, which adds nothing.
//   * MODE_ABLATE, the no-softmax ablation: p = bf16(s * scale * log2(e) *
//     1e-6), out = P V cast once: no max, no sum, no division; the same
//     loads and products, so it is the schedule's timing floor.
// Key tile, CTAs per SM and register split of each instantiation (the
// registers ptxas grants at launch, 65536 / (threads x CTAs per SM) to a
// multiple of 8, shared out by setmaxnreg):
//   qp=1  256 threads, 2 CTAs per SM, consumer 232 registers, 128 keys, 2 stages
//   qp=2  384 threads, 1 CTA per SM, consumer 240 registers, 128 keys, 2 stages
//   qp=4  640 threads, 1 CTA per SM, consumer 112 registers, 64 keys (32
//         keys pipelined: two S tiles, O and P in 112), 4 stages
// At 128 keys a consumer holds S (64 floats), O (32) and P (32), and two S
// tiles pipelined, in its 232 or 240 registers.
// Bound on an H100: as #1's, 4 B H N^2 D tensor-core operations and one
// exp2 per (q, k) pair, compute bound (1.417 ms at N = 18497, 16 heads).

#include "flash_variants_sm90.cuh"

namespace {

constexpr int XL_FLASH = 0, XL_ABLATE = 1;  // the modes of flash_variants.cuh's Mode: MODE_FLASH, MODE_ABLATE

template <int QP, bool PIPELINED>
struct XlShape {
    static constexpr int THREADS = 128 * (1 + QP);
    static constexpr int BQ = 64 * QP;
    static constexpr int BKV = QP < 4 ? 128 : PIPELINED ? 32 : 64;
    static constexpr int STAGES = BKV == 128 ? 2 : 4;
    static constexpr int CTAS_PER_SM = QP == 1 ? 2 : 1;
    static constexpr int LAUNCH_REGS = 65536 / (THREADS * CTAS_PER_SM) / 8 * 8;
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int CONSUMER_REGS = (LAUNCH_REGS * THREADS - 128 * PRODUCER_REGS) / (128 * QP) / 8 * 8;
    static constexpr int CTA_REGS = 128 * (PRODUCER_REGS + QP * CONSUMER_REGS);
    static constexpr int NS = BKV / 2;   // S floats per thread
    static constexpr int J = BKV / 16;   // PV k steps
    using Smem = VSmem<BQ, BKV, STAGES, STAGES>;
    static constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // slack to align the base
};

// Tile t's weights in place: the online softmax (alpha for O), or the
// ablation's p = s * scale_log2 * 1e-6 (0 on the pipelined loop's extra
// tile, which holds the last real tile's keys again; keys past N in a
// ragged tile are zero rows, so their s and v are 0).
template <int MODE, int NS>
__device__ __forceinline__ void weights(float (&s)[NS], float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2,
                                        int kbase, int n, int c) {
    if constexpr (MODE == XL_FLASH) {
        softmax_tile(s, m, l, alpha, scale_log2, kbase, n, c);
    } else {
        const float f = kbase < n ? scale_log2 : 0.f;
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = s[i] * f * 1e-6f;
    }
}

// pipelined, one key tile t: S_t complete in `cur`, PV_{t-1} in flight.
// PV_{t-1} is waited for first; then tile t+1's QK^T is issued into `nxt`,
// tile t's softmax runs under it, and PV_t is issued after it. Waiting for
// PV_{t-1} before that QK^T leaves one wgmma group in flight under the
// softmax: a wait that has to retire a group issued in the step before
// (across the loop's back edge) makes ptxas serialize every wgmma (C7514).
// On return PV_t is in flight and S_{t+1} complete.
template <int MODE, class Shape>
__device__ __forceinline__ void pipelined_step(typename Shape::Smem& sm, float (&cur)[Shape::NS], float (&nxt)[Shape::NS],
                                               float (&o)[32], uint32_t (&p)[Shape::J][4], float (&m)[2], float (&l)[2],
                                               uint64_t dq, float scale_log2, int t, int n, int lane, int c) {
    constexpr int S = Shape::STAGES;
    wgmma_wait<0>();  // PV_{t-1}
    fence_regs(o);
    if (t > 0) release(&sm.empty_v[stage_of<S>(t - 1)], lane);
    const int next = t + 1;
    mbar_wait(&sm.full_k[stage_of<S>(next)], parity_of<S>(next));
    fence_regs(nxt);
    wgmma_fence();
    issue_qk(nxt, dq, sm.k[stage_of<S>(next)]);
    wgmma_commit();
    float alpha[2];
    weights<MODE>(cur, m, l, alpha, scale_log2, t * Shape::BKV, n, c);
    if constexpr (MODE == XL_FLASH) rescale(o, alpha);
    pack_p(p, cur);
    mbar_wait(&sm.full_v[stage_of<S>(t)], parity_of<S>(t));
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv(o, p, sm.v[stage_of<S>(t)]);
    wgmma_commit();
    wgmma_wait<1>();  // QK^T_{t+1}
    fence_regs(nxt);
    release(&sm.empty_k[stage_of<S>(next)], lane);
}

// Consumer warpgroup `wg`: q rows q0 + 64 wg .. + 63 over every key tile.
template <int QP, bool PIPELINED, int MODE>
__device__ __forceinline__ void xl_consume(typename XlShape<QP, PIPELINED>::Smem& sm, const VParams& a, int wg, int q0, int b,
                                           int h, int tiles) {
    using Shape = XlShape<QP, PIPELINED>;
    constexpr int S = Shape::STAGES, NS = Shape::NS, J = Shape::J, BKV = Shape::BKV;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int n = a.n;
    const float sl2 = a.qk_scale_log2;
    const uint64_t dq = sw128_desc(sm.q + wg * 64 * D);

    float o[32], alpha[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t p[J][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    mbar_wait(&sm.full_q, 0);
    if constexpr (PIPELINED) {
        float sa[NS], sb[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) sa[i] = sb[i] = 0.f;  // overwritten by the first k step; keeps the operand defined
        const int pairs = (tiles + 1) / 2;  // the loop's tile count, 2 pairs, is even
        mbar_wait(&sm.full_k[0], 0);
        wgmma_fence();
        issue_qk(sa, dq, sm.k[0]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sa);
        release(&sm.empty_k[0], lane);
        for (int t = 0; t < 2 * pairs - 2; t += 2) {
            pipelined_step<MODE, Shape>(sm, sa, sb, o, p, m, l, dq, sl2, t, n, lane, c);
            pipelined_step<MODE, Shape>(sm, sb, sa, o, p, m, l, dq, sl2, t + 1, n, lane, c);
        }
        const int t = 2 * pairs - 2;
        pipelined_step<MODE, Shape>(sm, sa, sb, o, p, m, l, dq, sl2, t, n, lane, c);
        // the last tile: its softmax, then its PV once PV_{t} is done
        weights<MODE>(sb, m, l, alpha, sl2, (t + 1) * BKV, n, c);
        wgmma_wait<0>();
        fence_regs(o);
        release(&sm.empty_v[stage_of<S>(t)], lane);
        if constexpr (MODE == XL_FLASH) rescale(o, alpha);
        pack_p(p, sb);
        mbar_wait(&sm.full_v[stage_of<S>(t + 1)], parity_of<S>(t + 1));
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_pv(o, p, sm.v[stage_of<S>(t + 1)]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
    } else {
        float s[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = 0.f;
        // key tile 0: S only
        mbar_wait(&sm.full_k[0], 0);
        wgmma_fence();
        issue_qk(s, dq, sm.k[0]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        release(&sm.empty_k[0], lane);
        weights<MODE>(s, m, l, alpha, sl2, 0, n, c);
        pack_p(p, s);
        // key tile t: S_t and PV_{t-1} issued together, softmax_t under PV_{t-1}
        for (int t = 1; t < tiles; ++t) {
            const int st = stage_of<S>(t), pst = stage_of<S>(t - 1);
            mbar_wait(&sm.full_k[st], parity_of<S>(t));
            mbar_wait(&sm.full_v[pst], parity_of<S>(t - 1));
            fence_regs(o);
            fence_regs(p);
            wgmma_fence();
            issue_qk(s, dq, sm.k[st]);
            wgmma_commit();
            issue_pv(o, p, sm.v[pst]);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(s);
            release(&sm.empty_k[st], lane);
            weights<MODE>(s, m, l, alpha, sl2, t * BKV, n, c);
            wgmma_wait<0>();
            fence_regs(o);
            release(&sm.empty_v[pst], lane);
            if constexpr (MODE == XL_FLASH) rescale(o, alpha);
            pack_p(p, s);
        }
        // the last PV
        const int pst = stage_of<S>(tiles - 1);
        mbar_wait(&sm.full_v[pst], parity_of<S>(tiles - 1));
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_pv(o, p, sm.v[pst]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
    }
    store_rows<MODE == XL_FLASH>(o, l, a, q0 + wg * 64 + warp * 16 + g, b, h, c);
}

template <int QP, bool PIPELINED, int MODE>
__global__ void __launch_bounds__(XlShape<QP, PIPELINED>::THREADS, XlShape<QP, PIPELINED>::CTAS_PER_SM)
    fxl_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const VParams a) {
    using Shape = XlShape<QP, PIPELINED>;
    extern __shared__ uint8_t smem_raw[];
    auto& sm = aligned_smem<typename Shape::Smem>(smem_raw);
    const int b = blockIdx.x, q0 = blockIdx.y * Shape::BQ, h = blockIdx.z;  // batch fastest
    const int tiles = (a.n + Shape::BKV - 1) / Shape::BKV;

    if (threadIdx.x == 0) init_barriers<Shape::STAGES, Shape::STAGES>(sm, 4 * QP);
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every TMA copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Shape::PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            mbar_expect_tx(&sm.full_q, Shape::BQ * D * 2);
            tma_load(sm.q, &tq, &sm.full_q, 0, h, q0, b);
            // pipelined: an even count, the extra tile the last one again (masked by index)
            const int loads = PIPELINED ? tiles + (tiles & 1) : tiles;
            for (int t = 0; t < loads; ++t) {
                const int key0 = min(t, tiles - 1) * Shape::BKV;
                load_tile<Shape::BKV>(sm.k, sm.full_k, sm.empty_k, &tk, t, key0, h, b);
                load_tile<Shape::BKV>(sm.v, sm.full_v, sm.empty_v, &tv, t, key0, h, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Shape::CONSUMER_REGS) : "memory");
        xl_consume<QP, PIPELINED, MODE>(sm, a, threadIdx.x / 128 - 1, q0, b, h, tiles);
    }
}

template <int QP, bool PIPELINED, int MODE>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const VParams& p, int batch,
                   int heads, cudaStream_t stream) {
    using Shape = XlShape<QP, PIPELINED>;
    static std::atomic<unsigned long long> configured{0};
    cudaError_t err = configure(fxl_sm90<QP, PIPELINED, MODE>, Shape::THREADS, Shape::CTA_REGS, Shape::SMEM_BYTES, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid(batch, (p.n + Shape::BQ - 1) / Shape::BQ, heads);
    fxl_sm90<QP, PIPELINED, MODE><<<grid, Shape::THREADS, Shape::SMEM_BYTES, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

template <int QP, bool PIPELINED>
cudaError_t launch_qp(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                      const long long* v_st, const VParams& p, int batch, int heads, bool ablate, cudaStream_t stream) {
    using Shape = XlShape<QP, PIPELINED>;
    CUtensorMap tq, tk, tv;
    const cudaError_t err = encode_operands(tq, tk, tv, q, q_st, k, k_st, v, v_st, batch, p.n, heads, Shape::BQ, Shape::BKV);
    if (err != cudaSuccess) return err;
    return ablate ? launch<QP, PIPELINED, XL_ABLATE>(tq, tk, tv, p, batch, heads, stream)
                  : launch<QP, PIPELINED, XL_FLASH>(tq, tk, tv, p, batch, heads, stream);
}

template <int QP, bool PIPELINED>
int info_of(bool ablate, int* out) {
    using Shape = XlShape<QP, PIPELINED>;
    const int err = ablate ? resources(fxl_sm90<QP, PIPELINED, XL_ABLATE>, Shape::SMEM_BYTES, out)
                           : resources(fxl_sm90<QP, PIPELINED, XL_FLASH>, Shape::SMEM_BYTES, out);
    out[5] = Shape::BKV;
    out[6] = Shape::CONSUMER_REGS;
    return err;
}

}  // namespace

// Launch #10 on the current device. Pointers and (batch, row, head) element
// strides of q, k, v and out, as flash_attention_xl.cu's VArgs carries them;
// the caller has checked that tensor maps can read them (16-byte aligned
// bases and strides). qp: 1, 2 or 4. Returns the error of a tensor-map
// encode (a CUresult, whose codes agree with cudaError_t's for invalid
// values) or of the launch.
cudaError_t flash_xl_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                          const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads, int qp,
                          bool pipelined, bool ablate, float qk_scale_log2, cudaStream_t stream) {
    const VParams p{static_cast<__nv_bfloat16*>(o), o_st[0], o_st[1], o_st[2], n, 1, qk_scale_log2};
    if (qp == 1) return pipelined ? launch_qp<1, true>(q, q_st, k, k_st, v, v_st, p, batch, heads, ablate, stream)
                                  : launch_qp<1, false>(q, q_st, k, k_st, v, v_st, p, batch, heads, ablate, stream);
    if (qp == 2) return pipelined ? launch_qp<2, true>(q, q_st, k, k_st, v, v_st, p, batch, heads, ablate, stream)
                                  : launch_qp<2, false>(q, q_st, k, k_st, v, v_st, p, batch, heads, ablate, stream);
    if (qp == 4) return pipelined ? launch_qp<4, true>(q, q_st, k, k_st, v, v_st, p, batch, heads, ablate, stream)
                                  : launch_qp<4, false>(q, q_st, k, k_st, v, v_st, p, batch, heads, ablate, stream);
    return cudaErrorInvalidValue;
}

// An instantiation's resources, for a report (qp 1, 2 or 4; pipelined and
// ablate 0 or 1): registers per thread at launch (before setmaxnreg), local
// memory (spill) bytes per thread, static and dynamic shared memory bytes,
// threads per block; then its key tile and the consumers' registers after
// setmaxnreg. Returns the cudaError_t.
extern "C" int mdpt_flash_xl_sm90_info(int qp, int pipelined, int ablate, int* out) {
    if (qp == 1) return pipelined ? info_of<1, true>(ablate, out) : info_of<1, false>(ablate, out);
    if (qp == 2) return pipelined ? info_of<2, true>(ablate, out) : info_of<2, false>(ablate, out);
    if (qp == 4) return pipelined ? info_of<4, true>(ablate, out) : info_of<4, false>(ablate, out);
    return (int)cudaErrorInvalidValue;
}
