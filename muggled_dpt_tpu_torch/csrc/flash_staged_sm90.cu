// TPU kernel #11 for Hopper (sm_90a), bfloat16: experiments/flash_attention_staged.py:
// flash_attention_fused_qkv_staged (:144) -> _staged_qkv_kernel (:74), #1
// on the head-major (B, N, 3C) qkv slab, unbiased, D = 64, as a two-pass
// schedule with no online rescaling, on #1's Hopper pipeline
// (flash_attention_sm90.cu; function and numerics in flash_variants_sm90.cuh).
// The C entry mdpt_flash_attention_staged (flash_attention_staged.cu) sends
// every bfloat16 launch here; float32 runs fv_f32 (flash_variants.cuh).
//
// Design (one CTA per 192 q rows, head and batch; grid batch fastest):
//   * producer warpgroup (setmaxnreg.dec to 32), thread 0 issues TMA: the
//     192 x 64 Q tile once; pass 1 the K tiles of 128 keys into a 4-stage
//     ring; pass 2 the K tiles again through the same ring (its running
//     tile count goes on across the passes, so the barrier parities follow)
//     and the V tiles into a 2-stage ring.
//   * three consumer warpgroups of 64 q rows (setmaxnreg.inc to 160).
//     Pass 1 finds the exact row max over all keys: it holds no O and no P,
//     so it keeps two S accumulators and takes the key tiles in pairs, both
//     QK^T wgmma issued together and tile t's max run while tile t+1's is in
//     flight (the TPU kernel's "panel c's max read overlaps panel c+1's
//     dot"); nothing stays in flight across the loop (a wait that retires
//     a group issued before the back edge drew ptxas C7514, which
//     serializes every wgmma). The max is taken on raw s (on -s for a negative
//     scale: template NEG, the host's choice, so the loop has no branch on
//     it), keys at or past N masked by index before it (only the last pair
//     of tiles runs the masked max). Each panel of
//     _panel_bounds (whole 128-key tiles; the panel width arrives in
//     SLOT_PANEL) reduces its own max over the quad at its last tile, and the
//     row takes their maximum: max is exact, so the output does not depend
//     on the panels. An odd tile count gets one more tile, the last one
//     loaded again and masked by index (a wgmma under a runtime condition
//     makes ptxas serialize every wgmma, C7520).
//   * pass 2 is #1's loop without the rescale: S_t and PV_{t-1} issued
//     together, p = exp2(s * scale_log2 - m) under PV_{t-1} with the final
//     m, one FFMA and one ex2 per logit, no alpha, no per-tile max. The
//     recomputed s is the same wgmma on the same tiles as in pass 1, so
//     exp2's argument is at most 0 up to the one rounding of m = max * |scale_log2|.
// The TPU kernel keeps the whole logit row in VMEM; a 64-row f32 logit block
// at N = 18497 is 4.7 MB, so pass 2 recomputes QK^T instead.
// Bound on an H100: the function's, 4 B H N^2 D tensor-core operations
// (1.417 ms at N = 18497, 16 heads); the recompute makes the schedule's own
// floor 6 B H N^2 D (2.126 ms). K traffic from L2: twice N^2 H B * 128 B / 192.

#include "flash_variants_sm90.cuh"

namespace {

constexpr int CONSUMERS = 3;        // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;  // q rows per CTA
constexpr int BKV = 128;            // keys per K / V tile
constexpr int KSTAGES = 4, VSTAGES = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 160;
constexpr int CTA_REGS = 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
static_assert(CTA_REGS <= 65536, "the register file holds one CTA");
using Smem = VSmem<BQ, BKV, KSTAGES, VSTAGES>;
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // slack to align the base

// Pass 1, the raw row max of one S tile (of -s with NEG) folded into this
// panel's (mp); at a panel's last tile the panel's max joins the row's (mx).
// MASK: keys at or past N left out (the last pair of tiles). The fold is
// selected, not branched on: the quad's max is taken at every tile (a
// branch there cost pass 1 about a tenth on an H100; PERF.md).
template <bool NEG, bool MASK>
__device__ __forceinline__ void fold_max(const float (&s)[64], float (&mp)[2], float (&mx)[2], int t, int& panel_end,
                                         int panel_tiles, int n, int c) {
    row_max<MASK, NEG>(s, mp, t * BKV, n, c);
    const bool last = t + 1 == panel_end;  // the panel's last tile
    panel_end += last ? panel_tiles : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float q = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 1));
        q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, 2));
        mx[r] = last ? fmaxf(mx[r], q) : mx[r];
        mp[r] = last ? -INFINITY : mp[r];
    }
}

// Pass 1, key tiles t and t+1: both QK^T issued together, tile t's max
// taken while tile t+1's is in flight, then tile t+1's. Nothing is in
// flight across the loop: a wait that has to retire a wgmma group issued
// before the loop's back edge makes ptxas serialize every wgmma (C7514).
template <bool NEG, bool MASK>
__device__ __forceinline__ void max_pair(Smem& sm, float (&sa)[64], float (&sb)[64], float (&mp)[2], float (&mx)[2], uint64_t dq,
                                         int t, int& panel_end, int panel_tiles, int n, int lane, int c) {
    const int sta = stage_of<KSTAGES>(t), stb = stage_of<KSTAGES>(t + 1);
    mbar_wait(&sm.full_k[sta], parity_of<KSTAGES>(t));
    mbar_wait(&sm.full_k[stb], parity_of<KSTAGES>(t + 1));
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
    fold_max<NEG, MASK>(sa, mp, mx, t, panel_end, panel_tiles, n, c);
    wgmma_wait<0>();  // QK^T_{t+1}
    fence_regs(sb);
    release(&sm.empty_k[stb], lane);
    fold_max<NEG, MASK>(sb, mp, mx, t + 1, panel_end, panel_tiles, n, c);
}

// Pass 1 over every key tile, two at a time: the whole tiles first, with
// no mask; then the last pair, masked: the ragged last tile, or the last
// tile and the extra one of an odd count (the last tile loaded again, every
// key masked). Returns the raw row max (of -s with NEG), quad-uniform, in mx.
template <bool NEG>
__device__ __forceinline__ void pass1(Smem& sm, float (&mx)[2], uint64_t dq, int tiles, int panel_tiles, int n, int lane, int c) {
    float sa[64], sb[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sa[i] = sb[i] = 0.f;  // overwritten by the first k step; keeps the operand defined
    float mp[2] = {-INFINITY, -INFINITY};
    int panel_end = panel_tiles, t = 0;
    for (; t + 2 < tiles; t += 2) max_pair<NEG, false>(sm, sa, sb, mp, mx, dq, t, panel_end, panel_tiles, n, lane, c);
    max_pair<NEG, true>(sm, sa, sb, mp, mx, dq, t, panel_end, panel_tiles, n, lane, c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the last panel
        mp[r] = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 1));
        mp[r] = fmaxf(mp[r], __shfl_xor_sync(0xffffffffu, mp[r], 2));
        mx[r] = fmaxf(mx[r], mp[r]);
    }
}

// Pass 2's weights of one S tile in place: p = exp2(s * scale_log2 - m),
// 0 for keys at or past N (MASK), summed into l.
template <bool MASK>
__device__ __forceinline__ void exp_tile(float (&s)[64], const float (&m)[2], float (&l)[2], float scale_log2, int kbase, int n,
                                         int c) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[4 * i + e], scale_log2, -m[e >> 1]));
            s[4 * i + e] = MASK && key_masked(kbase, i, e, c, n) ? 0.f : p;
            l[e >> 1] += s[4 * i + e];
        }
    }
}

__device__ __forceinline__ void weights(float (&s)[64], const float (&m)[2], float (&l)[2], float scale_log2, int kbase, int n,
                                        int c) {
    if (kbase + BKV <= n) {
        exp_tile<false>(s, m, l, scale_log2, kbase, n, c);
    } else {
        exp_tile<true>(s, m, l, scale_log2, kbase, n, c);
    }
}

// Consumer warpgroup `wg`: q rows q0 + 64 wg .. + 63, both passes. K ring
// slots: pass 1 takes 0 .. k1 - 1 (k1 = tiles rounded up to even), pass 2
// k1 + t for key tile t; V ring slot t.
template <bool NEG>
__device__ __forceinline__ void consume(Smem& sm, const VParams& a, int wg, int q0, int b, int h, int tiles) {
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int n = a.n;
    const float sl2 = a.qk_scale_log2;
    const uint64_t dq = sw128_desc(sm.q + wg * 64 * D);
    const int k1 = tiles + (tiles & 1);

    mbar_wait(&sm.full_q, 0);
    float mx[2] = {-INFINITY, -INFINITY};
    pass1<NEG>(sm, mx, dq, tiles, a.panel_tiles, n, lane, c);
    const float m[2] = {mx[0] * fabsf(sl2), mx[1] * fabsf(sl2)};  // the row max of the logits, log2 units

    float s[64], o[32], l[2] = {0.f, 0.f};
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // key tile 0: S only
    mbar_wait(&sm.full_k[stage_of<KSTAGES>(k1)], parity_of<KSTAGES>(k1));
    wgmma_fence();
    issue_qk(s, dq, sm.k[stage_of<KSTAGES>(k1)]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(&sm.empty_k[stage_of<KSTAGES>(k1)], lane);
    weights(s, m, l, sl2, 0, n, c);
    pack_p(p, s);
    // key tile t: S_t and PV_{t-1} issued together, the weights of tile t under PV_{t-1}
    for (int t = 1; t < tiles; ++t) {
        const int kst = stage_of<KSTAGES>(k1 + t), vst = stage_of<VSTAGES>(t - 1);
        mbar_wait(&sm.full_k[kst], parity_of<KSTAGES>(k1 + t));
        mbar_wait(&sm.full_v[vst], parity_of<VSTAGES>(t - 1));
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
        weights(s, m, l, sl2, t * BKV, n, c);
        wgmma_wait<0>();
        fence_regs(o);
        release(&sm.empty_v[vst], lane);
        pack_p(p, s);
    }
    // the last PV
    const int vst = stage_of<VSTAGES>(tiles - 1);
    mbar_wait(&sm.full_v[vst], parity_of<VSTAGES>(tiles - 1));
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv(o, p, sm.v[vst]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    store_rows<true>(o, l, a, q0 + wg * 64 + warp * 16 + g, b, h, c);
}

// NEG: the scale is negative, so pass 1 takes the max of -s (the host's choice)
template <bool NEG>
__global__ void __launch_bounds__(THREADS, 1)
    fst_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const VParams a) {
    extern __shared__ uint8_t smem_raw[];
    Smem& sm = aligned_smem<Smem>(smem_raw);
    const int b = blockIdx.x, q0 = blockIdx.y * BQ, h = blockIdx.z;  // batch fastest
    const int tiles = (a.n + BKV - 1) / BKV;

    if (threadIdx.x == 0) init_barriers<KSTAGES, VSTAGES>(sm, 4 * CONSUMERS);
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every TMA copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            mbar_expect_tx(&sm.full_q, BQ * D * 2);
            tma_load(sm.q, &tq, &sm.full_q, 0, h, q0, b);
            const int k1 = tiles + (tiles & 1);
            for (int t = 0; t < k1; ++t)  // pass 1: K only; an odd count's extra tile is the last one again
                load_tile<BKV>(sm.k, sm.full_k, sm.empty_k, &tk, t, min(t, tiles - 1) * BKV, h, b);
            for (int t = 0; t < tiles; ++t) {  // pass 2: K and V
                load_tile<BKV>(sm.k, sm.full_k, sm.empty_k, &tk, k1 + t, t * BKV, h, b);
                load_tile<BKV>(sm.v, sm.full_v, sm.empty_v, &tv, t, t * BKV, h, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
        consume<NEG>(sm, a, threadIdx.x / 128 - 1, q0, b, h, tiles);
    }
}

template <bool NEG>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const VParams& p, int batch, int heads,
                   cudaStream_t stream) {
    static std::atomic<unsigned long long> configured{0};
    const cudaError_t err = configure(fst_sm90<NEG>, THREADS, CTA_REGS, SMEM_BYTES, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid(batch, (p.n + BQ - 1) / BQ, heads);
    fst_sm90<NEG><<<grid, THREADS, SMEM_BYTES, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace

// Launch #11 on the current device. Pointers and (batch, row, head) element
// strides of q, k, v and out, as flash_attention_staged.cu's VArgs carries
// them; the caller has checked that tensor maps can read them (16-byte
// aligned bases and strides). panel: keys per panel, a positive multiple of
// 128. Returns the error of a tensor-map encode (a CUresult, whose codes
// agree with cudaError_t's for invalid values) or of the launch.
cudaError_t flash_staged_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                              const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads, int panel,
                              float qk_scale_log2, cudaStream_t stream) {
    if (panel < BKV || panel % BKV != 0) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    const cudaError_t err = encode_operands(tq, tk, tv, q, q_st, k, k_st, v, v_st, batch, n, heads, BQ, BKV);
    if (err != cudaSuccess) return err;
    const VParams p{static_cast<__nv_bfloat16*>(o), o_st[0], o_st[1], o_st[2], n, panel / BKV, qk_scale_log2};
    return qk_scale_log2 < 0.f ? launch<true>(tq, tk, tv, p, batch, heads, stream)
                               : launch<false>(tq, tk, tv, p, batch, heads, stream);
}

// An instantiation's resources, for a report (neg 0 or 1: the scale's
// sign): registers per thread at launch (before setmaxnreg), local memory
// (spill) bytes per thread, static and dynamic shared memory bytes, threads
// per block; then its key tile and the consumers' registers after
// setmaxnreg. Returns the cudaError_t.
extern "C" int mdpt_flash_staged_sm90_info(int neg, int* out) {
    const int err = neg ? resources(fst_sm90<true>, SMEM_BYTES, out) : resources(fst_sm90<false>, SMEM_BYTES, out);
    out[5] = BKV;
    out[6] = CONSUMER_REGS;
    return err;
}
