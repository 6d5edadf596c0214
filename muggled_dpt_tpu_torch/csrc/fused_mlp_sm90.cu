// TPU kernel #8 for Hopper (sm_90a), bfloat16: experiments/pallas_fused_mlp.py:
// fused_ln_mlp_residual (:90) -> _kernel (:59), the second half of a pre-norm
// block with a GELU MLP,
//   out = x + ls * (fc2(gelu(fc1(layer_norm(x)))))
// on (rows, F) tokens with torch-layout weights fc1 (H, F) and fc2 (F, H). The
// C entry mdpt_fused_mlp (fused_mlp.cu) sends every bfloat16 launch here;
// float32 stays on mlp_f32 there. The rounding points are the TPU kernel's:
// LayerNorm statistics and affine step in f32, the normalized rows rounded
// to bf16; fc1 summed in f32 plus b1; exact (erf) GELU in f32, rounded to
// bf16; fc2 summed in f32 plus b2, times ls, plus the f32 residual; one
// rounding at the end.
//
// Design: three kernels on the caller's stream, the two intermediates in
// scratch the wrapper allocates (xn (rows, F) and G (rows, H), bf16):
//   1. mlp_ln_sm90: one warp per row, 16-byte loads; mean, then the variance
//      as a second pass over the row held in registers (not E[x^2] - E[x]^2:
//      DINOv2's residual streams carry large channels); the affine step,
//      rounded to bf16 into xn. The TPU kernel's _prep.
//   2. mlp_fc1_sm90: G = gelu(xn W1^T + b1), M = rows, N = H, K = F;
//   3. mlp_fc2_sm90: out = x + ls (G W2^T + b2), M = rows, N = F, K = H.
// Both GEMMs are one template on wgmma and TMA: both operands are K-major as
// they lie (xn and G by rows; W1 (H, F) and W2 (F, H) by rows), so 64-wide K
// slabs of a 128-row A tile and a BN-row B tile arrive by TMA (2-D tensor
// maps, 128-byte swizzle, zeros past every edge) into a ring of STAGES
// stages, each with a full and an empty mbarrier. A persistent grid, one CTA
// per SM, walks the output tiles N fastest (the CTAs at work share one A
// row block in L2). One producer warpgroup (setmaxnreg 40), whose thread 0
// issues every copy; two consumer warpgroups (setmaxnreg 232):
//   * cooperative (PINGPONG false): both on one 128 x BN tile, 64 rows each,
//     wgmma m64nBNk16 (BN = 256: 128 f32 accumulators per thread);
//   * ping-pong (PINGPONG true, BN = 128): each on tiles of its own, 128 x
//     128 as two m64n128k16 per k step; the producer fills the ring in tile
//     order, so one warpgroup's epilogue runs under the other's products.
// The schedule shipped (tools/mlp_sm90_variants.py measured the others):
// fc1 cooperative on 128 x 256 tiles (4 stages), fc2 cooperative on 128 x
// 128 (6 stages; 656 tiles at B = 8 fill 132 SMs 4.97 times where 128 x
// 256's 328 fill them 2.48 times). One wgmma group per K slab, retired
// before the next is issued and its stage released (the other consumer's
// group keeps the tensor cores busy meanwhile; a group kept in flight
// across slabs measured the same). The epilogue works on the accumulator's
// registers: + bias, then exact erff GELU (fc1) or times ls plus the
// residual read from x (fc2), packed to bf16 pairs and stored to global
// memory (a prefetch of the residual tile into L2 cost time); the
// bias and ls pairs are loaded under the products and handed over in
// shared memory, EPI_CHUNK blocks of 8 columns are taken at a time with
// their residual loads issued before their stores, every pair is computed
// and only the stores past the edges are dropped.
//
// Bound on an H100 at ViT-L, 504x504, B = 8 (10376 rows, F = 1024, H =
// 4096): 4 rows F H = 174 GFLOP on the tensor cores (0.176 ms at 989
// TFLOP/s) against 59 MB of tokens and weights and, in this design, the
// hidden activation G written once and read once (2 x 85 MB, 0.05 ms at
// 3.35 TB/s, under the products). What holds it (PERF.md, section 6): the
// cooperative epilogue runs while the tensor cores wait (fc1's 42.5 M erff
// and 64 pair stores per thread and tile; a consumer pair's products alone
// run at about 720 TFLOP/s), and one ping-pong consumer's products alone
// do not keep them busy. The (rows, H) G cannot stay on chip as in the TPU
// kernel: a 128-row tile's f32 fc2 accumulator over F = 1024 would fill
// the SM's register file.

#include "flash_variants_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                         // rows of a tile
constexpr int BK = 64;                          // K per stage: one 128-byte swizzle row of bf16
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup first
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // registers per thread after setmaxnreg
constexpr int CTA_REGS = 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS);
static_assert(CTA_REGS <= 65536, "the register file holds one CTA");
constexpr int RING_BYTES = 192 * 1024;          // the ring of stages
constexpr int MAX_F = 1024;                     // the LayerNorm pass holds a row of up to 1024 in a warp's registers
constexpr int LN_ROWS = 8;                      // rows per CTA of the LayerNorm pass, one warp each
constexpr int LN_CHUNKS = MAX_F / (8 * 32);     // 16-byte chunks of a row per lane
constexpr int EPI_GELU = 0, EPI_RESIDUAL = 1;   // fc1's epilogue, fc2's
constexpr int EPI_CHUNK = 4;                    // 8-column blocks the epilogue takes at a time
// The schedules (tools/mlp_sm90_variants.py edits these lines)
constexpr int FC1_BN = 256;
constexpr bool FC1_PINGPONG = false;
constexpr int FC2_BN = 128;
constexpr bool FC2_PINGPONG = false;

template <int BN>
constexpr int STAGE_BYTES = (BM + BN) * BK * 2;  // A tile, then B tile
template <int BN>
constexpr int STAGES = RING_BYTES / STAGE_BYTES<BN>;
template <int BN>
constexpr int EPI_BYTES = CONSUMERS * 2 * 2 * (BN / 2) * 4;  // per consumer, two tiles' bias and ls pairs
template <int BN>
constexpr int SMEM_BYTES = STAGES<BN> * STAGE_BYTES<BN> + EPI_BYTES<BN> + (2 * STAGES<BN> + CONSUMERS) * 8 + 1024;  // + barriers, slack

struct GemmParams {
    const bf16* bias;   // (N,): b1 or b2
    const bf16* ls;     // (N,): fc2's LayerScale
    const bf16* resid;  // (rows, N): fc2's residual x
    bf16* out;          // (rows, N): G (fc1) or out (fc2)
    int rows, n, k;
    int n_tiles, tiles;
};

#define ACC8(i) \
    "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 rows x 256, f32) = or += A (64 x 16 of K) B^T (256 x 16 of K), both K-major in shared memory
__device__ __forceinline__ void wgmma_k(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64), ACC8(72), ACC8(80),
          ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef ACC8

// The same over 128 columns: sm90_attention.cuh's m64n128k16 (K-major A and B)
__device__ __forceinline__ void wgmma_k(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    wgmma_qk(d, desc_a, desc_b, accumulate);
}

// One 2-D box at coordinates (c0, c1), innermost first, into shared memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ float gelu_erf(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

// 1. LayerNorm of LN_ROWS rows per CTA, one warp per row; lane l holds
// 16-byte chunks l, l + 32, .. of its row.
__global__ void __launch_bounds__(32 * LN_ROWS) mlp_ln_sm90(const bf16* x, const bf16* w, const bf16* b, bf16* xn, int rows, int f,
                                                          float eps) {
    const int lane = threadIdx.x % 32;
    const long long row = (long long)blockIdx.x * LN_ROWS + threadIdx.x / 32;
    if (row >= rows) return;
    const int chunks = f / 8;
    const uint4* src = reinterpret_cast<const uint4*>(x + row * f);
    float v[LN_CHUNKS][8];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < LN_CHUNKS; ++j) {
        const int ch = lane + 32 * j;
        if (ch < chunks) {
            unpack8(src[ch], v[j]);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[j][e];
    }
    const float mean = warp_sum(s) / f;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < LN_CHUNKS; ++j) {
        if (lane + 32 * j < chunks) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float d = v[j][e] - mean;
                q = fmaf(d, d, q);
            }
        }
    }
    const float rstd = rsqrtf(warp_sum(q) / f + eps);
    uint4* dst = reinterpret_cast<uint4*>(xn + row * f);
#pragma unroll
    for (int j = 0; j < LN_CHUNKS; ++j) {
        const int ch = lane + 32 * j;
        if (ch < chunks) {
            float g[8], bb[8];
            unpack8(reinterpret_cast<const uint4*>(w)[ch], g);
            unpack8(reinterpret_cast<const uint4*>(b)[ch], bb);
            uint32_t o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                o[i] = pack_bf16((v[j][2 * i] - mean) * rstd * g[2 * i] + bb[2 * i],
                                 (v[j][2 * i + 1] - mean) * rstd * g[2 * i + 1] + bb[2 * i + 1]);
            dst[ch] = make_uint4(o[0], o[1], o[2], o[3]);
        }
    }
}

// One K slab (ring slot `stage`) issued as one wgmma group: BK / 16 k steps
// of MT m64 blocks; A's rows a_row0 .. of the stage's 128-row tile.
// `first`: the tile's first slab, whose first k step overwrites the accumulator.
template <int BN, int MT>
__device__ __forceinline__ void issue_slab(float (&acc)[MT][BN / 2], const uint8_t* stage, int a_row0, int first) {
    const uint64_t da = sw128_desc(stage + a_row0 * BK * 2), db = sw128_desc(stage + BM * BK * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) wgmma_k(acc[mt], da + mt * (64 * BK * 2 >> 4) + 2 * kk, db + 2 * kk, kk > 0 || !first);
    }
    wgmma_commit();
}

// A tile's K slabs, ring slots idx .. idx + ksteps - 1, each retired
// before the next is issued and its stage released (a warp's lane 0
// arrives for it). `passed`: null, or a barrier to arrive on once every
// slab's full barrier has been passed (ping-pong's turn).
template <int BN, int MT>
__device__ __forceinline__ void mainloop(float (&acc)[MT][BN / 2], uint8_t* ring, uint64_t* full, uint64_t* empty, int idx, int ksteps,
                                         int a_row0, int lane, uint64_t* passed) {
    constexpr int S = STAGES<BN>;
    for (int ks = 0; ks < ksteps; ++ks, ++idx) {
        const int st = idx % S;
        mbar_wait(&full[st], (idx / S) & 1);
        issue_slab<BN, MT>(acc, ring + st * STAGE_BYTES<BN>, a_row0, ks == 0);
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        release(&empty[st], lane);
    }
    if (passed != nullptr) release(passed, lane);
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* q) { return __ldg(reinterpret_cast<const unsigned int*>(q)); }

__device__ __forceinline__ float2 bf16x2(uint32_t w) { return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w)); }

// The rows row0 + 64 mt + 16 warp + g + 8 h of this thread (sm90_attention.cuh's accumulator layout).
__device__ __forceinline__ int acc_row(int row0, int mt, int warp, int g, int h) { return row0 + 64 * mt + 16 * warp + g + 8 * h; }

// The tile's bias (and fc2's ls) pair of this consumer thread t: columns
// n0 + 2t, + 1 (BN / 2 <= 128 pairs a tile), 0 past N. Loaded when the
// tile's products start, written to the consumer's shared buffer once they
// are done and read by the epilogue after a barrier of the consumer (named
// barrier 1 + wg), so that the loads' latency hides under the products.
struct TileParams {
    uint32_t bias, ls;
};

template <int EPI, int BN>
__device__ __forceinline__ TileParams load_params(const GemmParams& p, int n0, int t) {
    static_assert(BN / 2 <= 128, "one pair per consumer thread");
    const bool in = t < BN / 2 && n0 + 2 * t < p.n;
    return {in ? ldg_u32(p.bias + n0 + 2 * t) : 0u, EPI == EPI_RESIDUAL && in ? ldg_u32(p.ls + n0 + 2 * t) : 0u};
}

template <int EPI, int BN>
__device__ __forceinline__ void store_params(const TileParams& v, uint32_t* buf, int t) {
    if (t < BN / 2) {
        buf[t] = v.bias;
        if constexpr (EPI == EPI_RESIDUAL) buf[BN / 2 + t] = v.ls;
    }
}

__device__ __forceinline__ void consumer_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); }

// The epilogue on the accumulator's registers: this thread holds, of each
// m64 block mt, rows acc_row(.., h = 0, 1) and, per 8-column block i,
// columns n0 + 8i + 2c, + 1; their bias (and ls) pairs are buf[4i + c]
// (and buf[BN / 2 + 4i + c]). The 8-column blocks are taken EPI_CHUNK at a
// time, fc2's residual pairs of a chunk loaded (by the read-only path)
// before its first store, so that their latencies overlap; every pair is
// computed and only the stores are predicated, so the chunk runs without
// branches.
template <int EPI, int BN, int MT>
__device__ __forceinline__ void epilogue(const float (&acc)[MT][BN / 2], const GemmParams& p, const uint32_t* buf, int row0, int n0,
                                         int warp, int lane) {
    const int g = lane / 4, c = lane % 4;
    const int col0 = n0 + 2 * c, cols = p.n - col0;  // columns col0 + 8i exist while 8i < cols (N is even: so do col0 + 8i + 1)
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += EPI_CHUNK) {
        uint32_t resid[MT][2][EPI_CHUNK];
        if constexpr (EPI == EPI_RESIDUAL) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = acc_row(row0, mt, warp, g, h);
                    const bf16* x = p.resid + (long long)row * p.n + col0;
#pragma unroll
                    for (int k = 0; k < EPI_CHUNK; ++k) resid[mt][h][k] = row < p.rows && 8 * (i0 + k) < cols ? ldg_u32(x + 8 * (i0 + k)) : 0u;
                }
            }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = acc_row(row0, mt, warp, g, h);
                bf16* out = p.out + (long long)row * p.n + col0;
#pragma unroll
                for (int k = 0; k < EPI_CHUNK; ++k) {  // every pair computed, only the stores predicated: no branches
                    const int i = i0 + k;
                    const float2 b = bf16x2(buf[4 * i + c]);
                    float y0 = acc[mt][4 * i + 2 * h] + b.x, y1 = acc[mt][4 * i + 2 * h + 1] + b.y;
                    if constexpr (EPI == EPI_GELU) {
                        y0 = gelu_erf(y0);
                        y1 = gelu_erf(y1);
                    } else {
                        const float2 sc = bf16x2(buf[BN / 2 + 4 * i + c]), r = bf16x2(resid[mt][h][k]);
                        y0 = fmaf(sc.x, y0, r.x);
                        y1 = fmaf(sc.y, y1, r.y);
                    }
                    const uint32_t v = pack_bf16(y0, y1);
                    if (row < p.rows && 8 * i < cols) *reinterpret_cast<uint32_t*>(out + 8 * i) = v;
                }
            }
        }
    }
}

// 2. and 3.: the persistent GEMM. CTA-local tile j (its tiles blockIdx.x,
// + gridDim.x, ..) fills ring slots j ksteps ..; cooperative: both
// consumers take every tile, ping-pong: consumer w the tiles j = w, w + 2, ..
// A consumer waits on a slot's full barrier by the parity of the fill it
// wants, which is safe only once the stage's earlier fills have completed.
// Cooperative consumers have waited for those themselves; a ping-pong
// consumer waits first for the other's turn on tile j - 1 (turn[w]
// completes a phase each time consumer w has passed its tile's full
// barriers), so the two take the ring in tile order.
template <int EPI, int BN, bool PINGPONG>
__device__ __forceinline__ void gemm(uint8_t* smem_raw, const CUtensorMap* ta, const CUtensorMap* tb, const GemmParams& p) {
    static_assert(BN == 128 || BN == 256, "wgmma m64n128 or m64n256");
    static_assert(!PINGPONG || BN == 128, "a ping-pong consumer holds a 128 x 128 tile: 128 accumulators per thread");
    constexpr int S = STAGES<BN>, MT = PINGPONG ? 2 : 1;
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE_BYTES<BN>);
    uint64_t* empty = full + S;
    uint64_t* turn = empty + S;
    uint32_t* params = reinterpret_cast<uint32_t*>(turn + CONSUMERS);  // per consumer, two buffers of BN bias and ls pairs
    const int ksteps = (p.k + BK - 1) / BK;

    if (threadIdx.x == 0) {
#pragma unroll
        for (int st = 0; st < S; ++st) {
            mbar_init(&full[st], 1);
            mbar_init(&empty[st], PINGPONG ? 4 : 4 * CONSUMERS);  // every warp of the stage's consumers
        }
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) mbar_init(&turn[w], 4);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // the producer warpgroup: thread 0 issues every TMA copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            int idx = 0;
            for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
                const int m0 = t / p.n_tiles * BM, n0 = t % p.n_tiles * BN;
                for (int ks = 0; ks < ksteps; ++ks, ++idx) {
                    const int st = idx % S;
                    uint8_t* stage = ring + st * STAGE_BYTES<BN>;
                    mbar_wait(&empty[st], ((idx / S) & 1) ^ 1);  // the first pass finds every stage free
                    mbar_expect_tx(&full[st], STAGE_BYTES<BN>);
                    tma_load2(stage, ta, &full[st], ks * BK, m0);
                    tma_load2(stage + BM * BK * 2, tb, &full[st], ks * BK, n0);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
        const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
        const int first = PINGPONG ? wg : 0, step = PINGPONG ? CONSUMERS : 1;
        const int a_row0 = PINGPONG ? 0 : 64 * wg;
        float acc[MT][BN / 2];
        for (int j = first, t = blockIdx.x + first * gridDim.x; t < p.tiles; j += step, t += step * gridDim.x) {
            const int row0 = t / p.n_tiles * BM + a_row0, n0 = t % p.n_tiles * BN;
            uint32_t* buf = params + (2 * wg + (j / step) % 2) * BN;  // this tile's: the consumer's buffer by tile parity
            const TileParams tp = load_params<EPI, BN>(p, n0, threadIdx.x % 128);
            if (PINGPONG && j > 0) mbar_wait(&turn[1 - wg], ((j - 1) / CONSUMERS) & 1);
            mainloop<BN, MT>(acc, ring, full, empty, j * ksteps, ksteps, a_row0, lane, PINGPONG ? &turn[wg] : nullptr);
            store_params<EPI, BN>(tp, buf, threadIdx.x % 128);
            consumer_sync(wg);  // the buffer is written; the buffer of two tiles back was read by every thread before
            epilogue<EPI, BN, MT>(acc, p, buf, row0, n0, warp, lane);
        }
    }
}

template <int BN, bool PINGPONG>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fc1_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const GemmParams p) {
    extern __shared__ uint8_t smem_raw[];
    gemm<EPI_GELU, BN, PINGPONG>(smem_raw, &ta, &tb, p);
}

template <int BN, bool PINGPONG>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fc2_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const GemmParams p) {
    extern __shared__ uint8_t smem_raw[];
    gemm<EPI_RESIDUAL, BN, PINGPONG>(smem_raw, &ta, &tb, p);
}

// A 2-D bf16 tensor map of a contiguous (rows, cols) matrix: boxes of BK
// columns x box_rows rows, 128-byte swizzle, zeros past the edges.
CUresult encode2(EncodeTiled fn, CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows}, unit[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, stride, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// One GEMM's launch: A (rows, K) and B (N, K) row-major bf16, the persistent grid over its tiles.
template <int BN, class Kernel>
cudaError_t launch_gemm(Kernel* kernel, std::atomic<unsigned long long>& configured, const void* a, const void* b, GemmParams p,
                        int sms, cudaStream_t stream) {
    cudaError_t err = configure(kernel, THREADS, CTA_REGS, SMEM_BYTES<BN>, configured);
    if (err != cudaSuccess) return err;
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    CUtensorMap ta, tb;
    CUresult r = encode2(fn, &ta, a, p.k, p.rows, BM);
    if (r == CUDA_SUCCESS) r = encode2(fn, &tb, b, p.k, p.n, BN);
    if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(r);
    p.n_tiles = (p.n + BN - 1) / BN;
    p.tiles = (p.rows + BM - 1) / BM * p.n_tiles;
    kernel<<<min(p.tiles, sms), THREADS, SMEM_BYTES<BN>, stream>>>(ta, tb, p);
    return cudaGetLastError();
}

}  // namespace

// Launch #8's three sm_90 kernels on the current device and `stream`: x and
// out (rows, F), the weights in torch layout, xn (rows, F) and g (rows, H)
// the wrapper's scratch, all contiguous bf16 with 16-byte aligned bases; F
// a multiple of 64 up to MAX_F, H a multiple of 8. `events`: null, or four
// cudaEvent_t recorded before the LayerNorm, fc1 and fc2 kernels and after
// fc2. Returns the error of a check (cudaErrorInvalidValue: a shape or an
// address a tensor map cannot read; nothing is launched), of a tensor-map
// encode (a CUresult, whose codes agree with cudaError_t's for invalid
// values) or of a launch.
cudaError_t fused_mlp_sm90(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* ls, void* out, void* xn, void* g, int rows, int f, int hidden, float eps,
                           void* const* events, cudaStream_t stream) {
    const void* ptrs[] = {x, ln_w, ln_b, w1, b1, w2, b2, ls, out, xn, g};
    for (const void* q : ptrs)
        if (q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 != 0) return cudaErrorInvalidValue;
    if (rows < 1 || f < 64 || f > MAX_F || f % 64 != 0 || hidden < 8 || hidden % 8 != 0) return cudaErrorInvalidValue;
    static std::atomic<unsigned long long> fc1_configured{0}, fc2_configured{0};
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    auto mark = [&](int i) { return events == nullptr ? cudaSuccess : cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream); };
    err = mark(0);
    if (err != cudaSuccess) return err;
    mlp_ln_sm90<<<(unsigned)((rows + LN_ROWS - 1) / LN_ROWS), 32 * LN_ROWS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b), static_cast<bf16*>(xn), rows, f,
        eps);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = mark(1);
    if (err != cudaSuccess) return err;
    const GemmParams p1{static_cast<const bf16*>(b1), nullptr, nullptr, static_cast<bf16*>(g), rows, hidden, f, 0, 0};
    err = launch_gemm<FC1_BN>(mlp_fc1_sm90<FC1_BN, FC1_PINGPONG>, fc1_configured, xn, w1, p1, sms, stream);
    if (err == cudaSuccess) err = mark(2);
    if (err != cudaSuccess) return err;
    const GemmParams p2{static_cast<const bf16*>(b2), static_cast<const bf16*>(ls), static_cast<const bf16*>(x),
                        static_cast<bf16*>(out), rows, f, hidden, 0, 0};
    err = launch_gemm<FC2_BN>(mlp_fc2_sm90<FC2_BN, FC2_PINGPONG>, fc2_configured, g, w2, p2, sms, stream);
    if (err == cudaSuccess) err = mark(3);
    return err;
}

// A kernel's resources, for a report (kernel: 0 the LayerNorm pass, 1 fc1,
// 2 fc2): registers per thread at launch (before setmaxnreg), local memory
// (spill) bytes per thread, static and dynamic shared memory bytes, threads
// per block; then its tile's rows and columns, its TMA stages and 1 for
// the ping-pong schedule. Returns the cudaError_t.
extern "C" int mdpt_fused_mlp_sm90_info(int kernel, int* out) {
    int err;
    if (kernel == 0) {
        err = resources(mlp_ln_sm90, 0, out);
        out[5] = LN_ROWS;
        out[6] = MAX_F;
        out[7] = 0;
        out[8] = 0;
    } else if (kernel == 1) {
        err = resources(mlp_fc1_sm90<FC1_BN, FC1_PINGPONG>, SMEM_BYTES<FC1_BN>, out);
        out[5] = BM;
        out[6] = FC1_BN;
        out[7] = STAGES<FC1_BN>;
        out[8] = FC1_PINGPONG ? 1 : 0;
    } else if (kernel == 2) {
        err = resources(mlp_fc2_sm90<FC2_BN, FC2_PINGPONG>, SMEM_BYTES<FC2_BN>, out);
        out[5] = BM;
        out[6] = FC2_BN;
        out[7] = STAGES<FC2_BN>;
        out[8] = FC2_PINGPONG ? 1 : 0;
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return err;
}
