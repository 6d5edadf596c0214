// TPU kernel #10 for Hopper (sm_90a): experiments/flash_attention_xl.py:
// flash_attention_fused_qkv_xl -> _xl_qkv_kernel (:69), the XL-N variants of
// #1 on the head-major (B, N, 3C) qkv slab, unbiased, D = 64: `qp` q blocks
// of 64 rows per CTA sharing each K/V tile (QP template parameter: 1, 2 or
// 4; 128 * QP threads), `pipelined` (key tile t+1's QK^T mma.sync issued
// before tile t's softmax), and the no-softmax ablation (p = s * 1e-6 cast
// to v's dtype, o = p v: the kernel structure's timing floor, not a valid
// attention). The kernel template, its numerics and its bound are in
// flash_variants.cuh; `hpp` and `block_q` were TPU tactics and reach no
// launch. float32 runs #1's FMA kernel with QP * 64 threads per CTA.

#include "flash_variants.cuh"

namespace {

template <int QP>
cudaError_t launch_xl(const VArgs& a, int mode, bool pipelined, int dtype, dim3 grid, cudaStream_t s) {
    if (mode == MODE_FLASH) {
        return pipelined ? launch_variant<QP, true, MODE_FLASH>(a, dtype, grid, s)
                         : launch_variant<QP, false, MODE_FLASH>(a, dtype, grid, s);
    }
    return pipelined ? launch_variant<QP, true, MODE_ABLATE>(a, dtype, grid, s)
                     : launch_variant<QP, false, MODE_ABLATE>(a, dtype, grid, s);
}

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot` (flash_variants.cuh); SLOT_MODE is MODE_FLASH or
// MODE_ABLATE. Returns the cudaError_t of the launch (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int mdpt_flash_attention_xl(const long long* args, float qk_scale, void* stream) {
    return variant_entry(args, qk_scale, stream,
                         [](const VArgs& a, int mode, int qp, bool pipelined, int dtype, dim3 grid, cudaStream_t s) {
                             if (mode != MODE_FLASH && mode != MODE_ABLATE) return cudaErrorInvalidValue;
                             if (qp == 1) return launch_xl<1>(a, mode, pipelined, dtype, grid, s);
                             if (qp == 2) return launch_xl<2>(a, mode, pipelined, dtype, grid, s);
                             return launch_xl<4>(a, mode, pipelined, dtype, grid, s);
                         });
}
