// TPU kernel #10, the C entry: experiments/flash_attention_xl.py:
// flash_attention_fused_qkv_xl (:140) -> _xl_qkv_kernel (:69), the XL-N
// variants of #1 on the head-major (B, N, 3C) qkv slab, unbiased, D = 64:
// `qp` q blocks of 64 rows per CTA sharing each K/V tile, `pipelined` (key
// tile t+1's QK^T issued before tile t's softmax), and the no-softmax
// ablation (p = s * 1e-6 cast to v's dtype, o = p v: the schedule's timing
// floor, not a valid attention). Every bfloat16 launch runs the wgmma/TMA
// kernels of flash_xl_sm90.cu, one instantiation per (qp, pipelined, mode);
// a layout their tensor maps cannot read is refused. float32 runs #1's FMA
// kernel with qp * 64 threads per CTA (fv_f32, flash_variants.cuh). `hpp`
// and `block_q` were TPU tactics and reach no launch.

#include "flash_variants.cuh"

// flash_xl_sm90.cu: every bfloat16 launch
cudaError_t flash_xl_sm90(const void* q, const long long* q_st, const void* k, const long long* k_st, const void* v,
                          const long long* v_st, void* o, const long long* o_st, int batch, int n, int heads, int qp,
                          bool pipelined, bool ablate, float qk_scale_log2, cudaStream_t stream);

namespace {

template <int QP>
cudaError_t launch_f32_xl(const VArgs& a, int mode, dim3 grid, cudaStream_t s) {
    return mode == MODE_FLASH ? launch_f32<QP, MODE_FLASH>(a, grid, s) : launch_f32<QP, MODE_ABLATE>(a, grid, s);
}

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot` (flash_variants.cuh); SLOT_MODE is MODE_FLASH or
// MODE_ABLATE. Returns the cudaError_t of the launch (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int mdpt_flash_attention_xl(const long long* args, float qk_scale, void* stream) {
    return variant_entry(args, qk_scale, stream, false,
                         [](const VArgs& a, int mode, int qp, bool pipelined, int dtype, dim3 grid, cudaStream_t s) {
                             if (mode != MODE_FLASH && mode != MODE_ABLATE) return cudaErrorInvalidValue;
                             if (dtype == 1) {
                                 const Strides st = strides_of(a);
                                 return flash_xl_sm90(a.q, st.q, a.k, st.k, a.v, st.v, a.o, st.o, grid.z, a.n, grid.y, qp,
                                                      pipelined, mode == MODE_ABLATE, a.qk_scale, s);
                             }
                             if (qp == 1) return launch_f32_xl<1>(a, mode, grid, s);
                             if (qp == 2) return launch_f32_xl<2>(a, mode, grid, s);
                             return launch_f32_xl<4>(a, mode, grid, s);
                         });
}
