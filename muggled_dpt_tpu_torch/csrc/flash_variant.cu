// TPU kernel #12 for Hopper (sm_90a): tools/attn_variants.py:flash_variant
// -> _onepass_kernel (:77) and _innerloop_kernel (:110), attention on
// pre-scaled (BH, N, D) q, k and v, D = 64, whose keys the JAX wrapper
// zero-pads to a multiple of 128; the kernel reads rows at or past N as
// zeros instead of a padded copy. One kernel template, the mode a template
// parameter (flash_variants.cuh): mask_exp and mask_exp2 (an iota mask, then
// exp or exp2: #4's math with the scale folded into q), padfix and chunk
// (MODE_PADFIX: the zero pad keys count in the max and pads * 2^-m is taken
// off l at each chunk end, including its failure when every real logit is far
// below 0), and the ablations nosm, maxonly (two passes: the final row max
// over real and pad keys first) and exponly. A measurement tool: no serving
// route reaches it.

#include "flash_variants.cuh"

namespace {

cudaError_t launch_mode(const VArgs& a, int mode, int dtype, dim3 grid, cudaStream_t s) {
    switch (mode) {
        case MODE_MASK_EXP: return launch_variant<1, false, MODE_MASK_EXP>(a, dtype, grid, s);
        case MODE_MASK_EXP2: return launch_variant<1, false, MODE_MASK_EXP2>(a, dtype, grid, s);
        case MODE_PADFIX: return launch_variant<1, false, MODE_PADFIX>(a, dtype, grid, s);
        case MODE_NOSM: return launch_variant<1, false, MODE_NOSM>(a, dtype, grid, s);
        case MODE_MAXONLY: return launch_variant<1, false, MODE_MAXONLY>(a, dtype, grid, s);
        case MODE_EXPONLY: return launch_variant<1, false, MODE_EXPONLY>(a, dtype, grid, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// C interface, bound with ctypes: `args` holds NUM_SLOTS int64 values laid
// out as in `Slot` (flash_variants.cuh); SLOT_MODE is one of the #12 modes,
// SLOT_QP 1. Returns the cudaError_t of the launch (0 on success); the launch
// is asynchronous on `stream`.
extern "C" int mdpt_flash_variant(const long long* args, float qk_scale, void* stream) {
    return variant_entry(args, qk_scale, stream,
                         [](const VArgs& a, int mode, int qp, bool pipelined, int dtype, dim3 grid, cudaStream_t s) {
                             if (qp != 1 || pipelined) return cudaErrorInvalidValue;
                             return launch_mode(a, mode, dtype, grid, s);
                         });
}
