// TPU kernel #9 for Hopper (sm_90a), bfloat16: experiments/pallas_head_conv.py:
// fused_head_tail (:77) -> _kernel (:52), the tail of a DPT head, per pixel
//   t[o] = relu(conv_b[o] + sum_{c, dy, dx} conv_w[o, c, dy, dx] * x[c, y + dy - 1, x + dx - 1])   (o < 32)
//   out  = act(proj_b + sum_o proj_w[o] * t[o]),  act = ReLU, or sigmoid for a metric head
// on an NCHW (B, ci, H, W) map with zero padding 1, giving (B, H, W): the conv
// summed in f32 plus its bias, ReLU, the 32 -> 1 projection in f32 plus its
// bias, the activation, one rounding. The C entry mdpt_head_tail
// (head_tail.cu) sends here every bfloat16 launch whose map a tensor map
// reads (W % 8 == 0: a 16-byte row stride; a 16-byte aligned base) with ci
// a multiple of 16 up to MAX_CHANNELS; the rest stays on head_tail<T>.
//
// Design: an implicit GEMM on wgmma, D[pixel, o] = sum over (tap, c) of
// x[c, row + dy - 1, pixel + dx - 1] w[o, c, dy, dx]: M = 64 pixels of one
// image row, N = 32 output channels (m64n32k16), K = 9 ci.
//   * a persistent grid, one CTA per SM, over units of ROWS output rows x 64
//     columns of one image (columns fastest, so neighbouring CTAs share
//     their halo rows in L2); ROWS is 8 up to ci = 128 and 6 beyond, where
//     the weights leave less room (an instantiation each, the host's
//     choice); 504 = 7 x 64 + 56, the last column block's
//     loads past W zero-filled by TMA and its stores masked by index;
//   * the conv weights, rearranged to 9 taps x ceil(ci / 64) tiles of 32
//     rows (o) x 64 channels, K-major with the 128-byte swizzle (wgmma's B),
//     are written to shared memory once per CTA and stay there (73.7 KB at
//     ci = 128, 110.6 KB at ci = 192);
//   * a producer warpgroup, whose thread 0 issues TMA over two 4-D maps
//     (W, C, H, B) of x into a ring of STAGES stages: per unit and
//     16-channel chunk a centre box of 64 columns x 16 channels x (ROWS +
//     2) rows at column x0 and row y0 - 1, with the 128-byte swizzle, and
//     two 8-column edge boxes at x0 - 8 and x0 + 64, unswizzled.
//     Coordinates past the image arrive as zeros, which is the conv's
//     padding, with no padded copy and no masking. A box lands
//     [row][channel][pixel], so the A operand of output row r and tap row dy
//     is the centre box's row r + dy: 16 channels of 64 pixels, MN-major
//     (wgmma transposes it), 2048 bytes from the last. The row shift dy
//     costs nothing. The column shift dx does: TMA faults on a box whose
//     innermost coordinate is not 16-byte aligned, and a descriptor's start
//     address moves in 16-byte steps, so the dx = 0 and dx = 2 operands are
//     copies of the centre box one pixel to the right and to the left (the
//     edge boxes give the pixel that enters), made by the consumers
//     themselves in shared memory, one chunk ahead, while the tensor cores
//     run the chunk before: a 16-byte load, two shuffles, four funnel
//     shifts and two 16-byte stores per 8 pixels, double-buffered;
//   * CONSUMERS warpgroups of ROWS / CONSUMERS output rows each: per chunk
//     one wgmma group (3 dx x 3 dy x its rows) issued, the next chunk's
//     shifted copies made under it, then retired; nothing in flight across
//     the chunk loop's back edge (ptxas C7514); a named barrier over the
//     consumers orders the copies with their readers;
//   * the epilogue on registers: a thread holds 2 pixels x 8 output
//     channels of each row's 64 x 32 accumulator; bias and ReLU, the dot
//     with proj_w, two shfl_xor across the quad, proj_b and the activation,
//     one bf16 per pixel. The (B, 32, H, W) map never leaves registers.
// Bound on an H100 at (8, 128, 504, 504): 2 B H W 32 (9 ci + 1) = 150
// GFLOP (0.151 ms at 989 TFLOP/s) against 520 MB of input (0.156 ms at
// 3.35 TB/s), about even; x is read from L2 (ROWS + 2) / ROWS times, and
// wgmma's operands per m64n32k16 (2 KB of A, 1 KB of B in 16 clocks of
// tensor work) ask shared memory for 1.5x what it gives.

#include "flash_variants_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CO = 32;                   // conv output channels: every DPT head's 3x3 conv -> 32
constexpr int MAX_CHANNELS = 192;        // ci of ViT-Giant's head; the weights then fill 110.6 KB
constexpr int PIX = 64;                  // pixels per row of a unit: wgmma's M
constexpr int CONSUMERS = 2;             // consumer warpgroups
constexpr int CH = 16;                   // channels per box: one wgmma k step
constexpr int ROW_BYTES = PIX * 2 * CH;  // one input row of a box: 2048 bytes, two swizzle atoms
constexpr int STAGES = 2;
constexpr int W_TILE_BYTES = CO * 128;   // 32 output channels x 64 input channels, one tap
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup first
// Output rows per unit, an instantiation each: 8 up to ci = 128, 6 beyond
// (ViT-Giant's 110.6 KB of weights leave room for no more)
constexpr int ROWS_WIDE = 8, ROWS_NARROW = 6, WIDE_CHANNELS = 128;
template <int ROWS> constexpr int ROWS_PER_WG = ROWS / CONSUMERS;
template <int ROWS> constexpr int BOX_ROWS = ROWS + 2;                          // input rows per box
template <int ROWS> constexpr int BOX_BYTES = PIX * 2 * CH * BOX_ROWS<ROWS>;    // the centre box, and each shifted copy
template <int ROWS> constexpr int EDGE_BYTES = 8 * 2 * CH * BOX_ROWS<ROWS>;     // an edge box: 8 columns
template <int ROWS> constexpr int STAGE_BYTES = BOX_BYTES<ROWS> + 2 * EDGE_BYTES<ROWS>;
template <int ROWS> constexpr int COPY_UNITS = BOX_ROWS<ROWS> * CH * 8 / (128 * CONSUMERS);  // per consumer thread
static_assert(ROWS_WIDE % CONSUMERS == 0 && ROWS_NARROW % CONSUMERS == 0 && BOX_ROWS<ROWS_WIDE> * CH * 8 % (128 * CONSUMERS) == 0 &&
                  BOX_ROWS<ROWS_NARROW> * CH * 8 % (128 * CONSUMERS) == 0,
              "whole rows and copies per consumer");

struct HtParams {
    const bf16* conv_w;  // (32, ci, 3, 3)
    const bf16* conv_b;  // (32,)
    const bf16* proj_w;  // (32,)
    const bf16* proj_b;  // (1,)
    bf16* out;           // (B, H, W)
    int ci, h, w, is_metric;
    int col_blocks, row_blocks, units;
};

// Shared memory, at a 1024-byte aligned address: the ring of TMA stages
// (centre box, left and right edge boxes), two sets of shifted copies (dx =
// 0, then dx = 2), the weights' tiles (9 taps x ceil(ci / 64)), then the
// barriers.
__host__ __device__ constexpr int weight_tiles(int ci) { return 9 * ((ci + 63) / 64); }
template <int ROWS>
__host__ __device__ constexpr int smem_bytes(int ci) {
    return STAGES * STAGE_BYTES<ROWS> + 2 * 2 * BOX_BYTES<ROWS> + weight_tiles(ci) * W_TILE_BYTES + 2 * STAGES * 8 +
           1024;  // slack to align the base
}

// d (64 pixels x 32 output channels, f32) += A (64 pixels x 16 channels, MN-major) B^T (32 x 16, K-major)
__device__ __forceinline__ void wgmma_conv(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
          "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The conv weights, OIHW in global memory, into the swizzled tiles: element
// (o, c, tap) at tile tap * ceil(ci / 64) + c / 64, row o, channel c % 64,
// its 16-byte unit XORed with the row's position in its 8-row group (the
// 128-byte swizzle). Every thread of the CTA takes part; a proxy fence
// makes the stores visible to wgmma.
__device__ __forceinline__ void load_weights(uint8_t* tiles, const bf16* w, int ci) {
    const int per_o = ci * 9, total = CO * per_o, groups = (ci + 63) / 64;
    for (int e = threadIdx.x; e < total; e += THREADS) {
        const int o = e / per_o, rem = e - o * per_o, c = rem / 9, tap = rem - c * 9, cc = c % 64;
        uint8_t* tile = tiles + (tap * groups + c / 64) * W_TILE_BYTES;
        *reinterpret_cast<bf16*>(tile + o * 128 + (((cc >> 3) ^ (o & 7)) << 4) + (cc & 7) * 2) = w[e];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Unit u: image b, output rows y0.., columns x0..
template <int ROWS>
__device__ __forceinline__ void unit_of(const HtParams& a, int u, int& b, int& y0, int& x0) {
    const int cb = u % a.col_blocks, rest = u / a.col_blocks;
    x0 = cb * PIX;
    y0 = (rest % a.row_blocks) * ROWS;
    b = rest / a.row_blocks;
}

// The shifted copies of one TMA stage's centre box: dx = 0 (one pixel to
// the right: pixel p holds x0 + p - 1) into `left`, dx = 2 (pixel p holds
// x0 + p + 1) into `right`, in the centre box's swizzled layout. Consumer
// thread t takes 16-byte unit t % 8 (pixels 8u .. 8u + 7) of box rows t / 8,
// t / 8 + 32, ...: eight lanes per row, so each unit's neighbours come by
// shuffle and the pixels that enter at the ends from the edge boxes. The
// stores are made visible to wgmma by a proxy fence.
template <int ROWS>
__device__ __forceinline__ void shift_copies(const uint8_t* stage, uint8_t* left, uint8_t* right, int t) {
    const uint8_t* el = stage + BOX_BYTES<ROWS>;  // [row][channel][8 pixels], unswizzled: x0 - 8 .. x0 - 1
    const uint8_t* er = el + EDGE_BYTES<ROWS>;    // x0 + 64 .. x0 + 71
    const int u = t & 7;
#pragma unroll
    for (int i = 0; i < COPY_UNITS<ROWS>; ++i) {
        const int q = (t >> 3) + i * (128 * CONSUMERS / 8);  // box row (input row, channel)
        const int off = q * 128 + ((u ^ (q & 7)) << 4);
        const uint4 w = *reinterpret_cast<const uint4*>(stage + off);
        uint32_t prev = __shfl_up_sync(0xffffffffu, w.w, 1, 8);    // pixels 8u - 2, 8u - 1
        uint32_t next = __shfl_down_sync(0xffffffffu, w.x, 1, 8);  // pixels 8u + 8, 8u + 9
        if (u == 0) prev = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(el + q * 16 + 14)) << 16;
        if (u == 7) next = *reinterpret_cast<const uint16_t*>(er + q * 16);
        const uint4 l = {__funnelshift_r(prev, w.x, 16), __funnelshift_r(w.x, w.y, 16), __funnelshift_r(w.y, w.z, 16),
                         __funnelshift_r(w.z, w.w, 16)};
        const uint4 r = {__funnelshift_r(w.x, w.y, 16), __funnelshift_r(w.y, w.z, 16), __funnelshift_r(w.z, w.w, 16),
                         __funnelshift_r(w.w, next, 16)};
        *reinterpret_cast<uint4*>(left + off) = l;
        *reinterpret_cast<uint4*>(right + off) = r;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumers' barrier (named barrier 1): every copy of a set written, every read of the other set done.
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory"); }

// Consumer warpgroup wg over one unit: its ROWS_PER_WG<ROWS> rows' accumulators,
// chunk by chunk. Chunk idx (the CTA's running count) reads TMA stage idx %
// STAGES and shifted set idx % 2; its wgmma group runs while the copies of
// chunk idx + 1 (if any, `total` chunks in all) are made; it returns with
// every wgmma retired.
template <int ROWS>
__device__ __forceinline__ void conv_unit(float (&acc)[ROWS_PER_WG<ROWS>][16], uint8_t* ring, uint8_t* shifted, uint64_t* full,
                                          uint64_t* empty, const uint8_t* tiles, int chunks, int groups, int& idx, int total,
                                          int wg, int lane) {
    const int t = threadIdx.x - 128;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WG<ROWS>; ++r)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[r][i] = 0.f;
    for (int kc = 0; kc < chunks; ++kc, ++idx) {
        const uint8_t* wk = tiles + (kc / 4) * W_TILE_BYTES;  // this chunk's 64-channel group, tap 0
        const int kstep = (kc % 4) * 2;                      // its 16 channels: 32 bytes into the 128-byte rows
        const int st = idx % STAGES;
        const uint8_t* src[3] = {shifted + (idx & 1) * 2 * BOX_BYTES<ROWS>, ring + st * STAGE_BYTES<ROWS>,
                                 shifted + (idx & 1) * 2 * BOX_BYTES<ROWS> + BOX_BYTES<ROWS>};  // dx = 0, 1, 2
#pragma unroll
        for (int r = 0; r < ROWS_PER_WG<ROWS>; ++r) fence_regs(acc[r]);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
                const uint64_t db = sw128_desc(wk + (dy * 3 + dx) * groups * W_TILE_BYTES) + kstep;
#pragma unroll
                for (int r = 0; r < ROWS_PER_WG<ROWS>; ++r)
                    wgmma_conv(acc[r], sw128_desc(src[dx] + (wg * ROWS_PER_WG<ROWS> + r + dy) * ROW_BYTES), db);
            }
        }
        wgmma_commit();
        if (idx + 1 < total) {  // the next chunk's copies, under this chunk's products
            const int next = (idx + 1) % STAGES;
            mbar_wait(&full[next], ((idx + 1) / STAGES) & 1);
            uint8_t* set = shifted + ((idx + 1) & 1) * 2 * BOX_BYTES<ROWS>;
            shift_copies<ROWS>(ring + next * STAGE_BYTES<ROWS>, set, set + BOX_BYTES<ROWS>, t);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int r = 0; r < ROWS_PER_WG<ROWS>; ++r) fence_regs(acc[r]);
        release(&empty[st], lane);
        consumers_sync();
    }
}

// Bias, ReLU, the projection and the activation of one unit's rows; one bf16 per pixel.
template <int ROWS>
__device__ __forceinline__ void epilogue(const float (&acc)[ROWS_PER_WG<ROWS>][16], const float (&cb)[8], const float (&pw)[8],
                                         float pb, const HtParams& a, int b, int y0, int x0, int wg, int warp, int lane) {
    const int g = lane / 4, c = lane % 4;
    const int px = x0 + warp * 16 + g + 8 * (c & 1);  // lanes c = 0 and 1 store rows g and g + 8
#pragma unroll
    for (int r = 0; r < ROWS_PER_WG<ROWS>; ++r) {
        float v[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 2 * i + (e & 1);  // output channel 8 i + 2 c + (e & 1)
                v[e >> 1] = fmaf(pw[j], fmaxf(acc[r][4 * i + e] + cb[j], 0.f), v[e >> 1]);
            }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], 1);
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], 2);
        }
        const int y = y0 + wg * ROWS_PER_WG<ROWS> + r;
        if (c < 2 && y < a.h && px < a.w) {
            float s = (c ? v[1] : v[0]) + pb;
            s = a.is_metric ? 1.f / (1.f + expf(-s)) : fmaxf(s, 0.f);
            a.out[((long long)b * a.h + y) * a.w + px] = __float2bfloat16(s);
        }
    }
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    ht_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap te, const HtParams a) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* shifted = ring + STAGES * STAGE_BYTES<ROWS>;
    uint8_t* tiles = shifted + 2 * 2 * BOX_BYTES<ROWS>;
    uint64_t* full = reinterpret_cast<uint64_t*>(tiles + weight_tiles(a.ci) * W_TILE_BYTES);
    uint64_t* empty = full + STAGES;
    const int lane = threadIdx.x % 32;
    const int chunks = a.ci / CH, groups = (a.ci + 63) / 64;

    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(&full[st], 1);
            mbar_init(&empty[st], 4 * CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    load_weights(tiles, a.conv_w, a.ci);
    __syncthreads();

    if (threadIdx.x < 128) {  // the producer warpgroup: thread 0 issues every TMA copy
        if (threadIdx.x == 0) {
            int idx = 0;
            for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
                int b, y0, x0;
                unit_of<ROWS>(a, u, b, y0, x0);
                for (int kc = 0; kc < chunks; ++kc, ++idx) {
                    const int st = idx % STAGES;
                    uint8_t* stage = ring + st * STAGE_BYTES<ROWS>;
                    mbar_wait(&empty[st], ((idx / STAGES) & 1) ^ 1);
                    mbar_expect_tx(&full[st], STAGE_BYTES<ROWS>);
                    tma_load(stage, &tx, &full[st], x0, kc * CH, y0 - 1, b);
                    tma_load(stage + BOX_BYTES<ROWS>, &te, &full[st], x0 - 8, kc * CH, y0 - 1, b);
                    tma_load(stage + BOX_BYTES<ROWS> + EDGE_BYTES<ROWS>, &te, &full[st], x0 + PIX, kc * CH, y0 - 1, b);
                }
            }
        }
        return;
    }
    const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 % 4;
    const int c = lane % 4;
    float cb[8], pw[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            cb[2 * i + e] = __bfloat162float(a.conv_b[8 * i + 2 * c + e]);
            pw[2 * i + e] = __bfloat162float(a.proj_w[8 * i + 2 * c + e]);
        }
    }
    const float pb = __bfloat162float(a.proj_b[0]);
    float acc[ROWS_PER_WG<ROWS>][16];
    const int total = (a.units - blockIdx.x + gridDim.x - 1) / gridDim.x * chunks;  // this CTA's chunks
    mbar_wait(&full[0], 0);  // chunk 0's copies
    shift_copies<ROWS>(ring, shifted, shifted + BOX_BYTES<ROWS>, threadIdx.x - 128);
    consumers_sync();
    int idx = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        int b, y0, x0;
        unit_of<ROWS>(a, u, b, y0, x0);
        conv_unit<ROWS>(acc, ring, shifted, full, empty, tiles, chunks, groups, idx, total, wg, lane);
        epilogue<ROWS>(acc, cb, pw, pb, a, b, y0, x0, wg, warp, lane);
    }
}

// A 4-D map (W, C, H, B) of x, its box `cols` columns x 16 channels x
// (ROWS + 2) rows, landing [row][channel][pixel]: the centre box with the
// 128-byte swizzle (64 columns), the edge boxes without (8 columns).
CUresult encode_input(CUtensorMap* map, const void* x, int batch, int ci, int h, int w, cuuint32_t cols, cuuint32_t rows,
                      CUtensorMapSwizzle swizzle) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
    const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)ci, (cuuint64_t)h, (cuuint64_t)batch};
    const cuuint64_t plane = (cuuint64_t)h * w * 2;
    const cuuint64_t stride[3] = {plane, (cuuint64_t)w * 2, plane * ci};
    const cuuint32_t box[4] = {cols, CH, rows, 1}, unit[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, stride, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int ROWS>
cudaError_t launch(const void* x, const HtParams& base, int batch, cudaStream_t stream) {
    static std::atomic<unsigned long long> configured{0};
    const int max_channels = ROWS == ROWS_WIDE ? WIDE_CHANNELS : MAX_CHANNELS;
    cudaError_t err = configure(ht_sm90<ROWS>, THREADS, 0, smem_bytes<ROWS>(max_channels), configured);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    CUtensorMap tx, te;
    CUresult r = encode_input(&tx, x, batch, base.ci, base.h, base.w, PIX, BOX_ROWS<ROWS>, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r == CUDA_SUCCESS) r = encode_input(&te, x, batch, base.ci, base.h, base.w, 8, BOX_ROWS<ROWS>, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(r);
    HtParams p = base;
    p.row_blocks = (p.h + ROWS - 1) / ROWS;
    p.units = batch * p.row_blocks * p.col_blocks;
    ht_sm90<ROWS><<<min(p.units, sms), THREADS, smem_bytes<ROWS>(p.ci), stream>>>(tx, te, p);
    return cudaGetLastError();
}

}  // namespace

// Launch #9's sm_90 kernel on the current device: x (B, ci, H, W) and out
// (B, H, W) contiguous bf16, the weights contiguous bf16 in the head's own
// layouts. The caller has checked that a tensor map reads x (a 16-byte
// aligned base, W % 8 == 0) and that ci is a multiple of 16 up to
// MAX_CHANNELS. Returns the error of a tensor-map encode (a CUresult,
// whose codes agree with cudaError_t's for invalid values) or of the launch.
cudaError_t head_tail_sm90(const void* x, const void* conv_w, const void* conv_b, const void* proj_w, const void* proj_b,
                           void* out, int batch, int ci, int h, int w, bool is_metric, cudaStream_t stream) {
    if (ci % CH != 0 || ci > MAX_CHANNELS || w % 8 != 0) return cudaErrorInvalidValue;
    const HtParams p{static_cast<const bf16*>(conv_w), static_cast<const bf16*>(conv_b), static_cast<const bf16*>(proj_w),
                     static_cast<const bf16*>(proj_b), static_cast<bf16*>(out), ci, h, w, is_metric ? 1 : 0,
                     (w + PIX - 1) / PIX, 0, 0};
    return ci <= WIDE_CHANNELS ? launch<ROWS_WIDE>(x, p, batch, stream) : launch<ROWS_NARROW>(x, p, batch, stream);
}

// An instantiation's resources, for a report (rows: 8 or 6 output rows per
// unit): registers per thread, local memory (spill) bytes per thread,
// static and dynamic shared memory bytes (at its largest ci), threads per
// block; then its output rows per unit and the TMA ring's stages. Returns
// the cudaError_t.
extern "C" int mdpt_head_tail_sm90_info(int rows, int* out) {
    int err;
    if (rows == ROWS_WIDE) {
        err = resources(ht_sm90<ROWS_WIDE>, smem_bytes<ROWS_WIDE>(WIDE_CHANNELS), out);
    } else if (rows == ROWS_NARROW) {
        err = resources(ht_sm90<ROWS_NARROW>, smem_bytes<ROWS_NARROW>(MAX_CHANNELS), out);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    out[5] = rows;
    out[6] = STAGES;
    return err;
}
