// SwinV2 window attention for Hopper (sm_90a), float32, bfloat16 and
// float16, with the continuous-position bias (CPB) and the shift mask kept
// factored. The C entry mdpt_window_attention sends every bfloat16 or
// float16 launch whose CPB and mask are of q's type and whose layouts a
// tensor map can read to csrc/window_attention_sm90.cu (wgmma and TMA); the
// kernels here take the float32 launches, 16-bit activations with float32
// biases (SwinV2's inline CPB tables), and layouts TMA cannot read.
//
// Replaces the TPU kernel muggled_dpt_tpu/ops/pallas/window_attention.py
// window_flash_attention -> _kernel (:31). Per batch b, window w and head h:
//   out[b, w, i, h, :] = sum_j softmax_j(q_i . k_j + cpb[h, i, j] + mask[w, i, j]) v_j
// on (B, nW, A, H, D) q, k, v and out, addressed by (batch, window, row, head)
// strides in elements with the head dim (D = 32) contiguous. q arrives
// l2-normalized and multiplied by the block's logit scale, k l2-normalized, so
// there is no scale argument. cpb is (H, A, A) and mask (nW, A, A) (0 / -100
// entries), each read by (head or window, row) strides with unit column
// stride: the (B, nW, H, A, A) sum of the two is never built anywhere, which
// is what the TPU kernel exists for (window_attention.py:3-9).
//
// Design: one CTA per (64-row q tile, head, batch * window), FlashAttention-2
// style: K/V tiles of 64 keys stream through shared memory and each q row
// keeps a running (max, sum, accumulator) in registers. The whole window is
// not assumed resident: the window plan's divisor search can give A = 1024 at
// 512x512 and up to (2 * 24 - 1)^2 = 2209, where K and V alone (283 KB in
// bf16) exceed a block's 227 KB. The TPU's 128-row padding and its NEG_INF
// padded bias were TPU tactics; here the ragged last key tile is masked by
// key index with NEG_INF, never by a pad-count correction.
// The two biases are fetched from global memory into registers in the layout
// of the logits, one key tile ahead (tile t+1's loads are issued at the top of
// tile t), and summed into one float pair per element when their tile comes
// up, so the loads of a whole tile of work hide their latency.
//
// Bounds on an H100: SwinV2-L-384 stage 1 (B=1, nW=16, A=576, H=6) does
// 2 * 2 * A^2 * D * H * nW = 1.3 GFLOP against 3 * A * C * nW * 2 B = 2.6 MB of
// bf16 q, k, v and (H + nW) * A^2 * 2 B = 7.3 MB of bf16 bias: about 130
// operations a byte, below the bf16 ridge (about 295), so the bias read and
// the latency of short K loops (9 key tiles) bound it, not the tensor cores.
// The 16-bit kernel wa_mma<T, TB, MASK> (T: __nv_bfloat16 or __half, the
// bias type TB: float or T) runs both products on the tensor cores
// (mma.sync m16n8k16, T in, f32 out) with K/V double-buffered by cp.async;
// the f32 kernel (the parity mode) uses plain FMAs, since TF32 would not
// hold float32 accuracy.
// Numerics kept from the TPU kernel: logits, softmax and accumulation in f32
// (exp2 domain: the logits are multiplied by log2(e)); p rounded to the input
// type before the PV product; out = acc / max(l, 1e-30).
// Left for later here: several heads per CTA to reuse the mask tile, and a
// persistent grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 32;              // head dim: every SwinV2 config has F / H = 32
constexpr float NEG_INF = -1e30f;  // the JAX package's masking constant
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    const void* cpb;
    const void* mask;  // null: no mask
    long long q_sb, q_sw, q_sn, q_sh;  // element strides: batch, window, row, head
    long long k_sb, k_sw, k_sn, k_sh;
    long long v_sb, v_sw, v_sn, v_sh;
    long long o_sb, o_sw, o_sn, o_sh;
    long long c_sh, c_sn;  // cpb: head and row strides (column stride 1)
    long long m_sw, m_sn;  // mask: window and row strides (column stride 1)
    int nw, n;             // windows per image, window area A
};

// The argument array's dtype codes (SLOT_DTYPE, SLOT_BIAS_DTYPE)
constexpr int CODE_F32 = 0, CODE_BF16 = 1, CODE_F16 = 2;

template <typename TB>
__device__ __forceinline__ float load_bias(const TB* p) {
    if constexpr (std::is_same<TB, float>::value) {
        return __ldg(p);
    } else {
        return __bfloat162float(*p);
    }
}

// ---------------------------------------------------------------------------
// float32: SIMT kernel, one thread per q row
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;  // q rows per CTA == threads per CTA
constexpr int F32_BK = 32;  // keys per shared-memory tile

template <typename TB, bool MASK>
__global__ void __launch_bounds__(F32_BQ) wa_f32(const Args a) {
    __shared__ float4 ks[F32_BK][D / 4];
    __shared__ float4 vs[F32_BK][D / 4];

    const int z = blockIdx.z, h = blockIdx.y;
    const int b = z / a.nw, w = z - b * a.nw;
    const int tid = threadIdx.x;
    const int n = a.n;
    const int qi = blockIdx.x * F32_BQ + tid;
    const int qrow = min(qi, n - 1);
    // this thread copies rows r0 + 8j (j = 0..3) of each tile, float4 column c4
    const int r0 = tid / (D / 4), c4 = tid % (D / 4);
    const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + w * a.k_sw + h * a.k_sh;
    const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + w * a.v_sw + h * a.v_sh;
    const TB* crow = static_cast<const TB*>(a.cpb) + h * a.c_sh + qrow * a.c_sn;
    const TB* mrow = MASK ? static_cast<const TB*>(a.mask) + w * a.m_sw + qrow * a.m_sn : nullptr;

    float4 q[D / 4];
    const float4* qp = reinterpret_cast<const float4*>(static_cast<const float*>(a.q) + b * a.q_sb + w * a.q_sw +
                                                       h * a.q_sh + qrow * a.q_sn);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
        const float4 t = qp[i];
        q[i] = make_float4(t.x * LOG2E, t.y * LOG2E, t.z * LOG2E, t.w * LOG2E);
    }

    float4 acc[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = NEG_INF, l = 0.f;

    for (int k0 = 0; k0 < n; k0 += F32_BK) {
        __syncthreads();  // the previous tile has been consumed
#pragma unroll
        for (int j = 0; j < F32_BK / 8; ++j) {
            const int row = k0 + r0 + 8 * j;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (row < n) {
                kv = reinterpret_cast<const float4*>(kb + row * a.k_sn)[c4];
                vv = reinterpret_cast<const float4*>(vb + row * a.v_sn)[c4];
            }
            ks[r0 + 8 * j][c4] = kv;
            vs[r0 + 8 * j][c4] = vv;
        }
        __syncthreads();

        // logits start from the biases (exp2 domain)
        float s[F32_BK];
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) {
            float bias = 0.f;
            if (k0 + j < n) {
                bias = load_bias(crow + k0 + j);
                if constexpr (MASK) bias += load_bias(mrow + k0 + j);
            }
            s[j] = bias * LOG2E;
        }
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
#pragma unroll
            for (int j = 0; j < F32_BK; ++j) {
                const float4 kv = ks[j][i];
                s[j] = fmaf(q[i].x, kv.x, s[j]);
                s[j] = fmaf(q[i].y, kv.y, s[j]);
                s[j] = fmaf(q[i].z, kv.z, s[j]);
                s[j] = fmaf(q[i].w, kv.w, s[j]);
            }
        }
        float m_new = m;
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) {
            if (k0 + j >= n) s[j] = NEG_INF;
            m_new = fmaxf(m_new, s[j]);
        }
        const float alpha = exp2f(m - m_new);
        m = m_new;
        l *= alpha;
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
            acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
        }
#pragma unroll
        for (int j = 0; j < F32_BK; ++j) {
            const float p = exp2f(s[j] - m);
            l += p;
#pragma unroll
            for (int i = 0; i < D / 4; ++i) {
                const float4 vv = vs[j][i];
                acc[i].x = fmaf(p, vv.x, acc[i].x);
                acc[i].y = fmaf(p, vv.y, acc[i].y);
                acc[i].z = fmaf(p, vv.z, acc[i].z);
                acc[i].w = fmaf(p, vv.w, acc[i].w);
            }
        }
    }

    if (qi < n) {
        const float lr = fmaxf(l, 1e-30f);
        float4* op = reinterpret_cast<float4*>(static_cast<float*>(a.o) + b * a.o_sb + w * a.o_sw + h * a.o_sh +
                                               qi * a.o_sn);
#pragma unroll
        for (int i = 0; i < D / 4; ++i)
            op[i] = make_float4(acc[i].x / lr, acc[i].y / lr, acc[i].z / lr, acc[i].w / lr);
    }
}

// ---------------------------------------------------------------------------
// bfloat16 or float16 (T): tensor-core kernel, 4 warps x 16 q rows, mma.sync
// m16n8k16
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // q rows per CTA (16 per warp)
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int LDS = D + 8;   // padded shared row (16-bit elements, 80 B): conflict-free fragment loads
constexpr int CHUNKS = D / 8;                // 16-byte chunks per row
constexpr int ROWS_PER_PASS = THREADS / CHUNKS;  // rows one pass of the CTA copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    // src-size 0 zero-fills the 16 bytes (rows past A)
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

// Copy 64 rows x 32 columns of one head's q, k or v into shared memory: 256
// chunks of 16 B, 2 per thread. This thread copies rows r0 + 32i (i = 0, 1)
// at column c0: p points at row r0 of the tile, at column c0; `first` is the
// tile's first row; `fallback` is a valid address for rows past A.
template <typename T>
__device__ __forceinline__ void load_tile(T (*dst)[LDS], const T* p, long long row_step, int first, int n, int r0, int c0,
                                          const T* fallback) {
#pragma unroll
    for (int i = 0; i < BK / ROWS_PER_PASS; ++i) {
        const bool valid = first + r0 + ROWS_PER_PASS * i < n;
        cp_async16(&dst[r0 + ROWS_PER_PASS * i][c0], valid ? p + i * row_step : fallback, valid);
    }
}

// Raw bias of one fragment element pair: float2 for a float32 bias, packed
// 16-bit pair for a bfloat16 or float16 one. Fetched a tile ahead, unpacked
// when its tile comes up.
template <typename TB>
using BiasRaw = typename std::conditional<std::is_same<TB, float>::value, float2, uint32_t>::type;

template <typename TB>
__device__ __forceinline__ float2 bias_unpack(BiasRaw<TB> v) {
    if constexpr (std::is_same<TB, float>::value) {
        return v;
    } else if constexpr (std::is_same<TB, __half>::value) {
        return __half22float2(*reinterpret_cast<const __half2*>(&v));
    } else {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    }
}

// This thread's bias for the 64-key tile at kbase, in the S C-fragment
// layout: rows g and g + 8 (row pointers row_g, row_g8; null past A), columns
// 2cq and 2cq + 1 of each 8-key tile nt; 0 past A. Every row starts at an even
// element (the wrapper guarantees it), so a pair is one aligned load.
template <typename TB>
__device__ __forceinline__ void bias_fetch(BiasRaw<TB> (&raw)[2][BK / 8], const TB* row_g, const TB* row_g8,
                                           int kbase, int n, int cq) {
    using Bits = typename std::conditional<std::is_same<TB, float>::value, float, unsigned short>::type;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const Bits* row = reinterpret_cast<const Bits*>(r == 0 ? row_g : row_g8);
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
            const int key = kbase + nt * 8 + 2 * cq;
            BiasRaw<TB> v{};
            if (row != nullptr) {
                if (key + 1 < n) {
                    v = *reinterpret_cast<const BiasRaw<TB>*>(row + key);
                } else if (key < n) {
                    if constexpr (std::is_same<TB, float>::value) v.x = row[key]; else v = row[key];
                }
            }
            raw[r][nt] = v;
        }
    }
}

template <typename T, typename TB, bool MASK>
__global__ void __launch_bounds__(THREADS) wa_mma(const Args a) {
    __shared__ __align__(16) T qs[BQ][LDS];
    __shared__ __align__(16) T ks[2][BK][LDS];
    __shared__ __align__(16) T vs[2][BK][LDS];

    const int z = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int b = z / a.nw, w = z - b * a.nw;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;  // fragment row group and column pair
    const int n = a.n;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + w * a.q_sw + h * a.q_sh;
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + w * a.k_sw + h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + w * a.v_sw + h * a.v_sh;
    // this thread's share of every tile copy: rows r0 + 32i, 16-byte column chunk c0
    const int r0 = tid / CHUNKS, c0 = (tid % CHUNKS) * 8;
    const T* kt = kb + r0 * a.k_sn + c0;  // advanced by one tile per iteration
    const T* vt = vb + r0 * a.v_sn + c0;
    const long long kstep = ROWS_PER_PASS * a.k_sn, vstep = ROWS_PER_PASS * a.v_sn;
    // this thread's logit rows are row_g and row_g + 8
    const int row_g = q0 + warp * 16 + g;

    load_tile(qs, qb + (q0 + r0) * a.q_sn + c0, ROWS_PER_PASS * a.q_sn, q0, n, r0, c0, qb);
    load_tile(ks[0], kt, kstep, 0, n, r0, c0, kb);
    load_tile(vs[0], vt, vstep, 0, n, r0, c0, vb);
    cp_async_commit();

    uint32_t qf[D / 16][4];  // this warp's Q A-fragments, one per 16-wide k step
    float acc[D / 8][4];     // O C-fragments, one per 8-wide column tile
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp's 16
    float l_r[2] = {0.f, 0.f};          // per-thread partial sums, reduced at the end

    // bias rows of logit rows row_g and row_g + 8 (null past A)
    const TB* cpb_head = static_cast<const TB*>(a.cpb) + h * a.c_sh;
    const TB* cpb_g = row_g < n ? cpb_head + row_g * a.c_sn : nullptr;
    const TB* cpb_g8 = row_g + 8 < n ? cpb_head + (row_g + 8) * a.c_sn : nullptr;
    const TB* mask_g = nullptr;
    const TB* mask_g8 = nullptr;
    BiasRaw<TB> cpb_next[2][BK / 8], mask_next[2][BK / 8];
    bias_fetch<TB>(cpb_next, cpb_g, cpb_g8, 0, n, cq);
    if constexpr (MASK) {
        const TB* mask_win = static_cast<const TB*>(a.mask) + w * a.m_sw;
        if (row_g < n) mask_g = mask_win + row_g * a.m_sn;
        if (row_g + 8 < n) mask_g8 = mask_win + (row_g + 8) * a.m_sn;
        bias_fetch<TB>(mask_next, mask_g, mask_g8, 0, n, cq);
    }

    const int num_tiles = (n + BK - 1) / BK;
    for (int t = 0; t < num_tiles; ++t) {
        const int st = t & 1;
        if (t + 1 < num_tiles) {
            kt += BK * a.k_sn;
            vt += BK * a.v_sn;
            load_tile(ks[st ^ 1], kt, kstep, (t + 1) * BK, n, r0, c0, kb);
            load_tile(vs[st ^ 1], vt, vstep, (t + 1) * BK, n, r0, c0, vb);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        if (t == 0) {
            const int rq = warp * 16 + g;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                qf[kk][0] = ld_u32(&qs[rq][kk * 16 + 2 * cq]);
                qf[kk][1] = ld_u32(&qs[rq + 8][kk * 16 + 2 * cq]);
                qf[kk][2] = ld_u32(&qs[rq][kk * 16 + 2 * cq + 8]);
                qf[kk][3] = ld_u32(&qs[rq + 8][kk * 16 + 2 * cq + 8]);
            }
        }

        // this tile's bias (cpb + mask, one float pair per element pair), then
        // the next tile's loads
        float2 bias[2][BK / 8];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
                bias[r][nt] = bias_unpack<TB>(cpb_next[r][nt]);
                if constexpr (MASK) {
                    const float2 mk = bias_unpack<TB>(mask_next[r][nt]);
                    bias[r][nt].x += mk.x;
                    bias[r][nt].y += mk.y;
                }
            }
        }
        if (t + 1 < num_tiles) {
            bias_fetch<TB>(cpb_next, cpb_g, cpb_g8, (t + 1) * BK, n, cq);
            if constexpr (MASK) bias_fetch<TB>(mask_next, mask_g, mask_g8, (t + 1) * BK, n, cq);
        }

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
                const T* kp = &ks[st][nt * 8 + g][kk * 16 + 2 * cq];
                mma_16816<T>(s[nt], qf[kk], ld_u32(kp), ld_u32(kp + 8));
            }
        }

        // exp2-domain logits plus bias, tail keys replaced, running row max
        const int kbase = t * BK;
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kbase + nt * 8 + 2 * cq + (e & 1);
                const float2 bp = bias[e >> 1][nt];
                float v = (s[nt][e] + ((e & 1) ? bp.y : bp.x)) * LOG2E;
                v = key < n ? v : NEG_INF;
                s[nt][e] = v;
                mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = exp2f(m_r[r] - mx[r]);
            m_r[r] = mx[r];
            l_r[r] *= alpha[r];
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            acc[dt][0] *= alpha[0];
            acc[dt][1] *= alpha[0];
            acc[dt][2] *= alpha[1];
            acc[dt][3] *= alpha[1];
        }

        // P = exp2(S - m), rounded to T; the S C-fragments of key tiles
        // 2j and 2j+1 are exactly the A-fragment of PV k step j
        uint32_t pf[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const float* sv = s[2 * j + half];
                const float p0 = exp2f(sv[0] - m_r[0]), p1 = exp2f(sv[1] - m_r[0]);
                const float p2 = exp2f(sv[2] - m_r[1]), p3 = exp2f(sv[3] - m_r[1]);
                l_r[0] += p0 + p1;
                l_r[1] += p2 + p3;
                pf[j][2 * half] = pack2<T>(p0, p1);
                pf[j][2 * half + 1] = pack2<T>(p2, p3);
            }
        }

        // O += P V; V B-fragments come transposed out of shared memory
        const int mtx = lane / 8, mrow = lane % 8;
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t vfrag[4];
                ldmatrix_x4_trans(vfrag, &vs[st][j * 16 + (mtx & 1) * 8 + mrow][dp * 16 + (mtx >> 1) * 8]);
                mma_16816<T>(acc[2 * dp], pf[j], vfrag[0], vfrag[1]);
                mma_16816<T>(acc[2 * dp + 1], pf[j], vfrag[2], vfrag[3]);
            }
        }
        __syncthreads();  // this stage is refilled two iterations on
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    T* ob = static_cast<T*>(a.o) + b * a.o_sb + w * a.o_sw + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_g + 8 * r;
        if (row < n) {
            const float lr = fmaxf(l_r[r], 1e-30f);
            T* op = ob + row * a.o_sn;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt)
                *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * cq) = pack2<T>(acc[dt][2 * r] / lr, acc[dt][2 * r + 1] / lr);
        }
    }
}

// f32 q/k/v (T = float) with a float32 or bfloat16 bias, or T q/k/v with
// a float32 bias or one of type T
template <typename T, typename TB>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
    const bool mask = a.mask != nullptr;
    if constexpr (std::is_same<T, float>::value) {
        if (mask) wa_f32<TB, true><<<grid, F32_BQ, 0, s>>>(a); else wa_f32<TB, false><<<grid, F32_BQ, 0, s>>>(a);
    } else {
        if (mask) wa_mma<T, TB, true><<<grid, THREADS, 0, s>>>(a); else wa_mma<T, TB, false><<<grid, THREADS, 0, s>>>(a);
    }
    return cudaGetLastError();
}

// Slots of the C entry's int64 argument array.
enum Slot {
    SLOT_Q = 0,        // q: address, then batch, window, row and head strides
    SLOT_K = 5,        // k: the same
    SLOT_V = 10,       // v: the same
    SLOT_O = 15,       // out: the same
    SLOT_CPB = 20,     // cpb: address, head and row strides
    SLOT_MASK = 23,    // mask: address (0: no mask), window and row strides
    SLOT_BATCH = 26,
    SLOT_WINDOWS,
    SLOT_AREA,
    SLOT_HEADS,
    SLOT_HEAD_DIM,
    SLOT_DTYPE,        // q, k, v and out: 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_BIAS_DTYPE,   // cpb and mask: 0 = float32, 1 = bfloat16, 2 = float16
    SLOT_DEVICE,       // the CUDA device of every tensor
    SLOT_ROUTE,        // written by the call: 1 = window_attention_sm90.cu ran, 0 = a kernel of this file
    NUM_SLOTS,
};

// Whether a tensor map can read an operand: a 16-byte aligned base and, for
// every dim of size > 1, a positive stride of a multiple of 8 elements (16
// bytes of 16-bit elements) below 2^39 elements (TMA: under 2^40 bytes).
bool tma_readable(long long addr, const long long* strides, const long long* sizes, int dims) {
    if (addr % 16 != 0) return false;
    for (int i = 0; i < dims; ++i)
        if (sizes[i] > 1 && (strides[i] <= 0 || strides[i] % 8 != 0 || strides[i] >= (1ll << 39))) return false;
    return true;
}

}  // namespace

cudaError_t window_attention_sm90(bool half, const void* q, const long long* q_st, const void* k, const long long* k_st,
                                  const void* v, const long long* v_st, void* o, const long long* o_st, const void* cpb,
                                  const long long* c_st, const void* mask, const long long* m_st, int batch, int nw, int n,
                                  int heads, cudaStream_t stream);

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid out
// as in `Slot`. Strides are in elements; the head dim of q, k, v and out and
// the column dim of cpb and mask are contiguous. The caller checks alignment:
// 16 B for q, k, v and out rows; an even element offset for every bias row.
// The dtype pairs taken (q, biases): (f32, f32), (f32, bf16), (bf16, f32),
// (bf16, bf16), (f16, f32), (f16, f16); any other is refused
// (cudaErrorInvalidValue). bfloat16 or float16 q, k, v with biases of the
// same type go to window_attention_sm90.cu when tma_readable holds for every
// operand (the kernels of this file take the rest); the call writes its
// choice to args[SLOT_ROUTE]. The launch goes to
// args[SLOT_DEVICE]; the calling thread's current device is the same after
// the call as before. Returns the cudaError_t of the launch (0 on success);
// the launch is asynchronous on `stream`.
extern "C" int mdpt_window_attention(long long* args, void* stream) {
    const int batch = (int)args[SLOT_BATCH], nw = (int)args[SLOT_WINDOWS], n = (int)args[SLOT_AREA];
    const int num_heads = (int)args[SLOT_HEADS], dtype = (int)args[SLOT_DTYPE];
    const int bias_dtype = (int)args[SLOT_BIAS_DTYPE], device = (int)args[SLOT_DEVICE];
    const void* cpb = reinterpret_cast<const void*>(args[SLOT_CPB]);
    if (args[SLOT_HEAD_DIM] != D || n < 1 || batch < 1 || nw < 1 || num_heads < 1 || num_heads > 65535 ||
        args[SLOT_BATCH] * args[SLOT_WINDOWS] > 65535)
        return (int)cudaErrorInvalidValue;
    const bool pair_taken = bias_dtype == CODE_F32 || bias_dtype == dtype || (dtype == CODE_F32 && bias_dtype == CODE_BF16);
    if (dtype < CODE_F32 || dtype > CODE_F16 || bias_dtype < CODE_F32 || bias_dtype > CODE_F16 || !pair_taken || cpb == nullptr)
        return (int)cudaErrorInvalidValue;
    const long long* q = args + SLOT_Q;
    const long long* k = args + SLOT_K;
    const long long* v = args + SLOT_V;
    const long long* o = args + SLOT_O;
    const long long* c = args + SLOT_CPB;
    const long long* mk = args + SLOT_MASK;
    const Args a{reinterpret_cast<const void*>(q[0]), reinterpret_cast<const void*>(k[0]),
                 reinterpret_cast<const void*>(v[0]), reinterpret_cast<void*>(o[0]), cpb,
                 reinterpret_cast<const void*>(mk[0]),
                 q[1], q[2], q[3], q[4], k[1], k[2], k[3], k[4], v[1], v[2], v[3], v[4], o[1], o[2], o[3], o[4],
                 c[1], c[2], mk[1], mk[2], nw, n};
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long rows[4] = {batch, nw, n, num_heads}, bias_rows[2] = {num_heads, n}, mask_rows[2] = {nw, n};
    const bool sm90 = dtype != CODE_F32 && bias_dtype == dtype && (long long)nw * num_heads <= 65535 &&
                      tma_readable(q[0], q + 1, rows, 4) && tma_readable(k[0], k + 1, rows, 4) &&
                      tma_readable(v[0], v + 1, rows, 4) && tma_readable(o[0], o + 1, rows, 4) &&
                      tma_readable(c[0], c + 1, bias_rows, 2) && (mk[0] == 0 || tma_readable(mk[0], mk + 1, mask_rows, 2));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (sm90) {
        err = window_attention_sm90(dtype == CODE_F16, a.q, q + 1, a.k, k + 1, a.v, v + 1, a.o, o + 1, cpb, c + 1, a.mask,
                                    mk + 1, batch, nw, n, num_heads, s);
    } else {
        const dim3 grid((n + BQ - 1) / BQ, num_heads, batch * nw);  // F32_BQ == BQ: one q tile of 64 rows per CTA
        if (dtype == CODE_F32) {
            err = bias_dtype == CODE_F32 ? launch<float, float>(a, grid, s) : launch<float, __nv_bfloat16>(a, grid, s);
        } else if (dtype == CODE_BF16) {
            err = bias_dtype == CODE_F32 ? launch<__nv_bfloat16, float>(a, grid, s) : launch<__nv_bfloat16, __nv_bfloat16>(a, grid, s);
        } else {
            err = bias_dtype == CODE_F32 ? launch<__half, float>(a, grid, s) : launch<__half, __half>(a, grid, s);
        }
    }
    args[SLOT_ROUTE] = sm90 ? 1 : 0;
    if (current != device) {
        const cudaError_t restored = cudaSetDevice(current);
        if (err == cudaSuccess) err = restored;
    }
    return (int)err;
}
